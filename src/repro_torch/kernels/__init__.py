"""Hand-written CUDA kernels (`csrc/`), their launch wrappers, their plain
PyTorch versions (`ref`) and the device dispatch between them (`ops`)."""
