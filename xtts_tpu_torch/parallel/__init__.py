"""Data- and tensor-parallel training and multi-device serving (port of
xtts_tpu/parallel/)."""
