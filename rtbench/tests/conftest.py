"""The benchmark's own CPU tests (``python -m pytest rtbench/tests``):
torch at two threads, the port on its plain paths."""
import torch

torch.set_num_threads(2)
