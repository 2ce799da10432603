"""Sharded sweeps and frame-sharded decoders on ``torch.distributed``."""
