"""Training substrate: optimizer, step construction, checkpointing."""
from . import checkpoint, optimizer, train_step
