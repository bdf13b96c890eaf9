"""Parallel rendering and training over torch.distributed (the
counterpart of hugs_tpu/parallel).

Two axes, as the JAX package lays them out on a TPU slice:
  'data' — frames: each data rank renders or trains its share of a batch;
  'tile' — horizontal pixel bands of one frame: each tile rank projects
           the whole (replicated) Gaussian set, shifts it into its band's
           frame and bins and blends only its band (K1 forward, K2
           backward on the card); the bands are gathered into the frame.

and one more, 'gauss' (gauss_shard.py, gauss_train.py): the rows of the
Gaussian set split over the ranks, each rank projecting and binning its
own, one exchange of fragments per frame, each rank blending its band.

`mesh.Mesh` holds the layout and one process group per axis; without a
process group it is (1, 1) and every collective is the identity, so a
single process never touches torch.distributed. `mesh.init_distributed`
joins the group torchrun describes (`python -m torch.distributed.run
--nproc_per_node=N ...`; NCCL on cards, gloo on the CPU); multihost.py
lays the mesh over several hosts.
"""
from hugs_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, factor_devices, init_distributed, make_gauss_mesh, make_mesh,
)
