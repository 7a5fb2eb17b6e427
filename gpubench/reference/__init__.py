"""The plain reference: the published model in f32 torch operations.

It imports nothing of the port and nothing of JAX, and takes no tensor
the program made: its weights come from ``gpubench.weights.make`` with
the run's seed, and its token ids from the traffic generator.
"""
