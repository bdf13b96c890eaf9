"""A frozen copy of the port's plain PyTorch path, the benchmark's
reference.

These modules are hugs_tpu_torch's models, ops, render, losses and train
step modules as they stood when the benchmark was written, with the
imports pointed here, the CUDA blend replaced by the plain blend that it
was written against (render/renderer.py) and the loader's PLY reader
left out. They import nothing of hugs_tpu_torch, so that a change to the
program cannot move the reference it is judged by. They run in float32
with TF32 off, as the configurations state; losses/basic.py's TF32
switch runs the convolutions in TF32 for the control.
"""
