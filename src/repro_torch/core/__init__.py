"""MOD-Sketch core, PyTorch port: hashing, the flat sketch, the hierarchy,
the signed Count-Sketch, space-saving pools and the block padding the
endpoint uses."""
from repro_torch.core.hashing import KeySchema, P31  # noqa: F401
