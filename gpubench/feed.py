"""The training cells' batches, made on the device from the seed."""

import torch

# the data stream's generator: the weights' seed, salted
DATA_SALT = 0xDA7A


class Feed:
    """A new batch a step: ``batch`` rows of ``seq + 1`` uniform ids
    drawn on the device; the tokens are the first ``seq``, the labels
    the last ``seq`` (every label counts)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int, device):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) ^ DATA_SALT)
        self.device = device
        self.positions = torch.arange(seq, dtype=torch.int32,
                                      device=device).expand(batch, seq)

    def next(self):
        x = torch.randint(0, self.vocab, (self.batch, self.seq + 1),
                          generator=self.gen, device=self.device)
        return x[:, :-1], x[:, 1:]
