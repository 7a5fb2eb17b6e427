"""The names of the JAX package's ``types/constants.py`` that the port
needs, with the same values: the slice membership file and the
generation variable are the slice agent's contract with a workload, so
the port reads what the agent writes."""

# Membership generation a container's slice identity belongs to; a
# workload compares it with the live membership file
# (workloads.checkpoint.ReshapeSignal) to see that the slice reshaped
# under it and a checkpoint-restart is due.
ENV_TPU_SLICE_GENERATION = "TPU_SLICE_GENERATION"

# Crash-safe membership file the slice agent keeps current on the host.
SLICE_STATE_FILE = "/var/lib/tpu-slice/membership.json"
