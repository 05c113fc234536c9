"""The benchmark of egobox_torch on NVIDIA GPUs (see run.py)."""
