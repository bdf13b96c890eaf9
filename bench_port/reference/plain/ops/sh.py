"""Real spherical harmonics for Gaussian-splat view-dependent colour.

Semantics of 3DGS's eval_sh for degrees 0..4: given SH coefficients laid
out (..., C, (deg+1)^2) and unit view directions (..., 3), return colours
(..., C). The constants are the JAX package's, digit for digit.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> DC SH coefficient (3DGS RGB2SH)."""
    return (rgb - 0.5) / C0


def sh_basis_rows(max_deg: int, x, y, z):
    """SH basis values as a list of (max_deg+1)^2 tensors shaped like x.

    The batch axis stays the last axis of every row; same constants and
    order as eval_sh."""
    basis = [torch.full_like(x, C0)]
    if max_deg >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if max_deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * xz, C2[4] * (xx - yy)]
    if max_deg >= 3:
        basis += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                  C3[2] * y * (4 * zz - xx - yy),
                  C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                  C3[6] * x * (xx - 3 * yy)]
    if max_deg >= 4:
        basis += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
                  C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
                  C4[4] * (zz * (35 * zz - 30) + 3),
                  C4[5] * xz * (7 * zz - 3),
                  C4[6] * (xx - yy) * (7 * zz - 1),
                  C4[7] * xz * (xx - 3 * yy),
                  C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return basis


def eval_sh_rows(max_deg: int, active_deg, sh_rows: torch.Tensor,
                 x, y, z) -> torch.Tensor:
    """Row-major masked SH evaluation.

    sh_rows: (K*C, N) with row k*C + c = coefficient k of channel c
    (shs (N, K, C).reshape(N, K*C).T). x/y/z: (N,) unit direction rows.
    Returns (C, N). Bands above `active_deg` (an int or a 0-d tensor) are
    zeroed, as in eval_sh_masked.
    """
    active = torch.as_tensor(active_deg, device=sh_rows.device)
    out = None
    for k, b in enumerate(sh_basis_rows(max_deg, x, y, z)):
        deg_k = int(k ** 0.5)
        if deg_k > 0:
            b = b * (active >= deg_k).to(b.dtype)
        term = b[None, :] * sh_rows[3 * k:3 * k + 3]
        out = term if out is None else out + term
    return out
