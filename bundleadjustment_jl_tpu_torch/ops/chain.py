"""The BAL linearization chain on batched rows (PyTorch port of
`pallas_linearize.project_chain` and `pallas_linearize.linearize_chain`).

Per observation row: Rodrigues rotation and its r-derivative, the
perspective divide, radial distortion and focal, all closed form and
scalarized — each quantity is an (N,) tensor, the 3-vector / 3x3 structure
is unrolled in Python. ``csrc/chain.cuh`` holds the same arithmetic for
the CUDA kernels, in the same order; these functions are the plain
versions the kernels are checked against.

Outputs are weighted by ``w`` and zeroed where the point lies on the
camera plane (z == 0), so padding rows (w = 0) contribute exact zeros.
"""

from __future__ import annotations

import torch

from bundleadjustment_jl_tpu_torch.models.camera import SMALL_THETA_SQ


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _split(c, X, obs):
    cols = c.unbind(-1)
    return (cols[0:3], cols[3:6], cols[6], cols[7], cols[8], X.unbind(-1),
            obs.unbind(-1))


def _rotation_guard(r):
    th2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    safe = th2 > SMALL_THETA_SQ
    th = torch.sqrt(torch.where(safe, th2, torch.ones_like(th2)))
    return th2, safe, th


def project_residual(c, X, obs, w) -> torch.Tensor:
    """Weighted residual (N, 2) of rows ``c`` (N, 9), ``X`` (N, 3),
    ``obs`` (N, 2), ``w`` (N,) — the forward half of the chain."""
    r, t, k1, k2, f, X, obs = _split(c, X, obs)
    th2, safe, th = _rotation_guard(r)
    inv_th = 1.0 / th
    k = [r[0] * inv_th, r[1] * inv_th, r[2] * inv_th]
    cs = torch.cos(th)
    sn = torch.sin(th)
    one_c = 1.0 - cs
    kxX = _cross(k, X)
    kdX = k[0] * X[0] + k[1] * X[1] + k[2] * X[2]
    RX_big = [cs * X[a] + sn * kxX[a] + one_c * kdX * k[a] for a in range(3)]
    rxX = _cross(r, X)
    rxrxX = _cross(r, rxX)
    RX_small = [X[a] + rxX[a] + 0.5 * rxrxX[a] for a in range(3)]
    RX = [torch.where(safe, RX_big[a], RX_small[a]) for a in range(3)]
    p1 = [RX[a] + t[a] for a in range(3)]
    z = p1[2]
    z_ok = z != 0.0
    inv_z = 1.0 / torch.where(z_ok, z, torch.ones_like(z))
    p2 = [-p1[0] * inv_z, -p1[1] * inv_z]
    n2 = p2[0] * p2[0] + p2[1] * p2[1]
    frho = f * (1.0 + k1 * n2 + k2 * n2 * n2)
    valid = torch.where(z_ok, w, torch.zeros_like(w))
    return torch.stack([(frho * p2[i] - obs[i]) * valid for i in range(2)],
                       dim=-1)


def linearize(c, X, obs, w):
    """``(res (N, 2), Jc (N, 2, 9), Jp (N, 2, 3))`` of rows ``c`` (N, 9),
    ``X`` (N, 3), ``obs`` (N, 2), ``w`` (N,). Jc columns are
    ``[d/dr | d/dt | d/d(k1, k2, f)]``."""
    r, t, k1, k2, f, X, obs = _split(c, X, obs)
    one = torch.ones_like(w)
    zero = torch.zeros_like(w)

    def eye(a, b):
        return one if a == b else zero

    def hat(v, a, b):
        tbl = {(0, 1): -v[2], (0, 2): v[1], (1, 0): v[2],
               (1, 2): -v[0], (2, 0): -v[1], (2, 1): v[0]}
        return tbl.get((a, b), zero)

    # Stage 1: RX = R(r) X and D = d(RX)/dr.
    th2, safe, th = _rotation_guard(r)
    inv_th = 1.0 / th
    k = [r[0] * inv_th, r[1] * inv_th, r[2] * inv_th]
    cs = torch.cos(th)
    sn = torch.sin(th)
    one_c = 1.0 - cs
    kxX = _cross(k, X)
    kdX = k[0] * X[0] + k[1] * X[1] + k[2] * X[2]

    R_big = [[cs * eye(a, b) + sn * hat(k, a, b) + one_c * k[a] * k[b]
              for b in range(3)] for a in range(3)]
    RX_big = [cs * X[a] + sn * kxX[a] + one_c * kdX * k[a] for a in range(3)]
    D_big = [[(-sn * X[a] * k[b] + cs * kxX[a] * k[b]
               - sn * inv_th * (hat(X, a, b) + kxX[a] * k[b])
               + sn * kdX * k[a] * k[b]
               + one_c * inv_th * (k[a] * X[b]
                                   + kdX * (eye(a, b) - 2.0 * k[a] * k[b])))
              for b in range(3)] for a in range(3)]

    # theta ~ 0: 2nd-order Taylor forms.
    rxX = _cross(r, X)
    rxrxX = _cross(r, rxX)
    RX_small = [X[a] + rxX[a] + 0.5 * rxrxX[a] for a in range(3)]
    R_small = [[eye(a, b) + hat(r, a, b) + 0.5 * (r[a] * r[b]
                                                  - th2 * eye(a, b))
                for b in range(3)] for a in range(3)]
    rdX = r[0] * X[0] + r[1] * X[1] + r[2] * X[2]
    D_small = [[(-hat(X, a, b) - 0.5 * (hat(rxX, a, b) + X[a] * r[b]
                                        - rdX * eye(a, b)))
                for b in range(3)] for a in range(3)]

    RX = [torch.where(safe, RX_big[a], RX_small[a]) for a in range(3)]
    R = [[torch.where(safe, R_big[a][b], R_small[a][b]) for b in range(3)]
         for a in range(3)]
    D = [[torch.where(safe, D_big[a][b], D_small[a][b]) for b in range(3)]
         for a in range(3)]

    # Stage 2: perspective divide.
    p1 = [RX[a] + t[a] for a in range(3)]
    z = p1[2]
    z_ok = z != 0.0
    inv_z = 1.0 / torch.where(z_ok, z, one)
    p2 = [-p1[0] * inv_z, -p1[1] * inv_z]

    # Stage 3: radial distortion and focal.
    n2 = p2[0] * p2[0] + p2[1] * p2[1]
    rho = 1.0 + k1 * n2 + k2 * n2 * n2
    frho = f * rho
    proj = [frho * p2[0], frho * p2[1]]
    g = 2.0 * k1 + 4.0 * k2 * n2
    B = [[f * (rho + g * p2[0] * p2[0]), f * g * p2[0] * p2[1]],
         [f * g * p2[0] * p2[1], f * (rho + g * p2[1] * p2[1])]]
    fn2 = f * n2
    J_dist = [[fn2 * p2[i], fn2 * n2 * p2[i], rho * p2[i]] for i in range(2)]
    inv_z2 = inv_z * inv_z
    BA = [[-B[i][0] * inv_z, -B[i][1] * inv_z,
           (B[i][0] * p1[0] + B[i][1] * p1[1]) * inv_z2] for i in range(2)]

    valid = torch.where(z_ok, w, zero)
    Jp = [[(BA[i][0] * R[0][b] + BA[i][1] * R[1][b]
            + BA[i][2] * R[2][b]) * valid for b in range(3)]
          for i in range(2)]
    Jr = [[(BA[i][0] * D[0][b] + BA[i][1] * D[1][b]
            + BA[i][2] * D[2][b]) * valid for b in range(3)]
          for i in range(2)]
    res = torch.stack([(proj[i] - obs[i]) * valid for i in range(2)], -1)
    Jc = torch.stack([
        torch.stack(Jr[i] + [BA[i][b] * valid for b in range(3)]
                    + [J_dist[i][b] * valid for b in range(3)], -1)
        for i in range(2)], -2)
    Jp = torch.stack([torch.stack(Jp[i], -1) for i in range(2)], -2)
    return res, Jc, Jp
