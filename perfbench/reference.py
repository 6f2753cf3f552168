"""The plain reference of a BAL solve: Levenberg-Marquardt over the Schur
complement with block-Jacobi PCG, in plain PyTorch.

It implements what a configuration states, from the generated arrays alone
(the observations' camera and point ids, the image points and a start),
and works out again everything a solver derives from them: residuals and
the Jacobian (automatic differentiation of the BAL camera model, not a
hand-derived chain), the normal-equation blocks, the reduced
camera system, its diagonal blocks, the Schur matvec, the back-substitution
and the trial objective. It imports torch and numpy only: nothing of the
system under test.

The algorithm is the one the solver documents (the JAX driver's
semantics): lambda from the largest diagonal entry times 1e-3, damping by
``lam I``, the reference's lambda schedule, the forcing sequence
``clip(sqrt(||g||), 1e-10, 1e-2)`` for CG, and the stops on the step, the
gradient, the residual and the objective change. Where W is stored below
four bytes (the configuration's ``facto_dtype``) the reference rounds W to
that type, and takes the narrow-storage rules: the CG floor of 8 eps of the
storage type, the stop after 8 CG steps without a 4% gain, and the
predicted-reduction stop. Tolerances left unset resolve in the working
type the configuration states.

Every sum over observations runs over blocks of rows, so a problem of
tens of millions of rows fits beside nothing else on one card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Status codes, as the solver's result reports them.
STATUS = {"first_order": 1, "small_residual": 2, "small_step": 3,
          "small_obj_change": 4, "max_iter": 5, "exception": 6}
CG_FLOOR_MULT = 8.0
STAGNATION_WINDOW = 8
LIN_BLOCK = 1 << 21      # rows a block for the Jacobian
BLOCK = 1 << 22          # rows a block for the other sums


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def project(cam: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The BAL (Snavely) camera model: ``X`` (..., 3) seen by ``cam``
    (..., 9) = (axis-angle r, t, k1, k2, f), as image point (..., 2)."""
    r, t = cam[..., 0:3], cam[..., 3:6]
    k1, k2, f = cam[..., 6], cam[..., 7], cam[..., 8]
    theta = torch.sqrt(torch.sum(r * r, -1, keepdim=True)).clamp_min(1e-30)
    k = r / theta
    c, s = torch.cos(theta), torch.sin(theta)
    kdx = torch.sum(k * X, -1, keepdim=True)
    p1 = c * X + s * _cross(k, X) + (1 - c) * kdx * k + t
    p2 = -p1[..., 0:2] / p1[..., 2:3]
    n2 = torch.sum(p2 * p2, -1)
    rho = 1.0 + k1 * n2 + k2 * n2 * n2
    return (f * rho)[..., None] * p2


def jacobian(c: torch.Tensor, X: torch.Tensor):
    """``(r, Jc, Jp)`` of rows ``c`` (n, 9), ``X`` (n, 3): the projections
    (n, 2) and their Jacobians (n, 2, 9), (n, 2, 3), by reverse-mode
    differentiation, one pass an image coordinate (a row's projection
    depends on its own camera and point copies alone)."""
    with torch.enable_grad():
        c = c.detach().requires_grad_(True)
        X = X.detach().requires_grad_(True)
        proj = project(c, X)
        rows = [torch.autograd.grad(proj[:, i].sum(), (c, X),
                                    retain_graph=i == 0) for i in (0, 1)]
    Jc = torch.stack([g[0] for g in rows], 1)
    Jp = torch.stack([g[1] for g in rows], 1)
    return proj.detach(), Jc, Jp


class Blocks(NamedTuple):
    obj: float
    gnorm: float
    g_c: torch.Tensor    # (ncams, 9)
    g_p: torch.Tensor    # (npnts, 3)
    Hcc: torch.Tensor    # (ncams, 9, 9)
    Hpp: torch.Tensor    # (npnts, 3, 3)
    W: torch.Tensor      # (nobs, 9, 3), rounded to W's storage type


class Solve(NamedTuple):
    cams: torch.Tensor
    points: torch.Tensor
    objective: float
    gnorm: float
    iterations: int
    status: int
    naccepts: int
    hist_obj: list
    hist_gnorm: list
    hist_cg: list


class Reference:
    """A BAL problem as the reference holds it: the observations' camera
    and point ids (int), the image points, the sizes, the compute type
    ``dtype`` (float64 as the rule), W's storage type ``w_dtype`` (None:
    ``dtype``) and the working type ``work_dtype`` the configuration states,
    in which unset tolerances resolve."""

    def __init__(self, cam_idx, pnt_idx, pt2d, ncams: int, npnts: int, *,
                 dtype=torch.float64, w_dtype=None,
                 work_dtype=torch.float32):
        self.cam = cam_idx.long()
        self.pnt = pnt_idx.long()
        self.obs = pt2d.to(dtype)
        self.n = self.cam.shape[0]
        self.ncams, self.npnts = ncams, npnts
        self.dtype = dtype
        self.w_dtype = w_dtype or dtype
        self.work_dtype = work_dtype
        self.dev = self.obs.device

    def _rows(self, step=BLOCK):
        for lo in range(0, self.n, step):
            yield slice(lo, min(lo + step, self.n))

    # ----- sums over the observations ------------------------------------
    def objective(self, cams, points) -> float:
        cams, points = cams.to(self.dtype), points.to(self.dtype)
        total = torch.zeros((), dtype=self.dtype, device=self.dev)
        for b in self._rows():
            r = project(cams[self.cam[b]], points[self.pnt[b]]) - self.obs[b]
            total += torch.sum(r * r)
        return 0.5 * float(total)

    def linearize(self, cams, points) -> Blocks:
        dt = self.dtype
        nc, npt = self.ncams, self.npnts
        z = dict(dtype=dt, device=self.dev)
        g_c, g_p = torch.zeros(nc, 9, **z), torch.zeros(npt, 3, **z)
        Hcc, Hpp = torch.zeros(nc, 81, **z), torch.zeros(npt, 9, **z)
        W = torch.empty(self.n, 9, 3, **z)
        obj = torch.zeros((), **z)
        for b in self._rows(LIN_BLOCK):
            cb, pb = self.cam[b], self.pnt[b]
            proj, Jc, Jp = jacobian(cams[cb].to(dt), points[pb].to(dt))
            r = proj - self.obs[b]
            obj += torch.sum(r * r)
            g_c.index_add_(0, cb, torch.einsum("kia,ki->ka", Jc, r))
            g_p.index_add_(0, pb, torch.einsum("kia,ki->ka", Jp, r))
            Hcc.index_add_(0, cb, torch.einsum("kia,kib->kab", Jc, Jc)
                           .reshape(-1, 81))
            Hpp.index_add_(0, pb, torch.einsum("kia,kib->kab", Jp, Jp)
                           .reshape(-1, 9))
            W[b] = torch.einsum("kia,kib->kab", Jc, Jp).to(self.w_dtype).to(dt)
        gnorm = math.sqrt(float(torch.sum(g_c * g_c) + torch.sum(g_p * g_p)))
        return Blocks(0.5 * float(obj), gnorm, g_c, g_p, Hcc.reshape(-1, 9, 9),
                      Hpp.reshape(-1, 3, 3), W)

    def _cam_sum(self, W, op_pnt):
        """sum over rows of W_k op[pnt_k], by camera (ncams, 9)."""
        out = torch.zeros(self.ncams, 9, dtype=self.dtype, device=self.dev)
        for b in self._rows():
            out.index_add_(0, self.cam[b], torch.einsum(
                "kab,kb->ka", W[b], op_pnt[self.pnt[b]]))
        return out

    def _pnt_sum(self, W, op_cam):
        """sum over rows of W_k' op[cam_k], by point (npnts, 3)."""
        out = torch.zeros(self.npnts, 3, dtype=self.dtype, device=self.dev)
        for b in self._rows():
            out.index_add_(0, self.pnt[b], torch.einsum(
                "kab,ka->kb", W[b], op_cam[self.cam[b]]))
        return out

    def _wcw(self, W, Hpp_inv):
        """sum over rows of W_k Hpp_inv[pnt_k] W_k', by camera."""
        out = torch.zeros(self.ncams, 81, dtype=self.dtype, device=self.dev)
        for b in self._rows(BLOCK // 4):
            Wb = W[b]
            out.index_add_(0, self.cam[b], torch.einsum(
                "kab,kbc,kdc->kad", Wb, Hpp_inv[self.pnt[b]], Wb)
                .reshape(-1, 81))
        return out.reshape(-1, 9, 9)

    # ----- one damped step -------------------------------------------------
    def step(self, blk: Blocks, lam: float, rtol: float, max_iters: int,
             stagnation: int):
        """``(dc, dp, ||J d||^2, CG steps)``: the Schur-complement PCG step
        at ``lam``."""
        eye9 = torch.eye(9, dtype=self.dtype, device=self.dev)
        eye3 = torch.eye(3, dtype=self.dtype, device=self.dev)
        Hcc_l = blk.Hcc + lam * eye9
        Hpp_inv = torch.linalg.inv(blk.Hpp + lam * eye3)
        v = torch.einsum("pab,pb->pa", Hpp_inv, blk.g_p)
        b = -blk.g_c + self._cam_sum(blk.W, v)
        Sd = Hcc_l - self._wcw(blk.W, Hpp_inv)
        L, info = torch.linalg.cholesky_ex(Sd)
        L = torch.where((info == 0)[:, None, None], L,
                        torch.full_like(L, float("nan")))
        Minv = torch.cholesky_inverse(L)

        def matvec(x):
            t = torch.einsum("pab,pb->pa", Hpp_inv, self._pnt_sum(blk.W, x))
            return torch.einsum("cab,cb->ca", Hcc_l, x) - self._cam_sum(
                blk.W, t)

        dc, iters = pcg(matvec, b, Minv, rtol, max_iters, stagnation)
        dp = -torch.einsum("pab,pb->pa", Hpp_inv,
                           blk.g_p + self._pnt_sum(blk.W, dc))
        cross = self._cam_sum(blk.W, dp)
        Jd2 = (torch.sum(dc * torch.einsum("cab,cb->ca", blk.Hcc, dc))
               + 2.0 * torch.sum(cross * dc)
               + torch.sum(dp * torch.einsum("pab,pb->pa", blk.Hpp, dp)))
        return dc, dp, float(Jd2), iters

    # ----- the solve ---------------------------------------------------------
    def solve(self, cams, points, opts: dict) -> Solve:
        """Levenberg-Marquardt from ``(cams, points)`` with the solver
        options ``opts`` (the configuration's ``solver``)."""
        if opts.get("lam0_mode", "diag") != "diag":
            raise ValueError("the reference takes lam0_mode 'diag' only")
        eps = float(torch.finfo(self.work_dtype).eps)

        def opt(key, default):
            v = opts.get(key)
            return default if v is None else float(v)

        atol, rtol = opt("atol", eps ** 0.5), opt("rtol", eps ** (1 / 3))
        satol, srtol = opt("satol", eps ** 0.5), opt("srtol", eps ** 0.5)
        oatol, ortol = opt("oatol", eps ** 0.5), opt("ortol", eps ** (1 / 3))
        restol = opt("restol", eps ** (1 / 3))
        nu_d, nu_m = opt("nu_d", 3.0), opt("nu_m", 3.0)
        accept_ratio = opt("accept_ratio", 1e-4)
        good_ratio, lam_min = opt("good_ratio", 0.9), opt("lam_min", 1e-8)
        max_iters = int(opts.get("max_iters", 200))
        pcg_max = int(opts.get("pcg_max_iters", 100))
        narrow = (torch.finfo(self.w_dtype).bits < 32
                  or torch.finfo(self.work_dtype).bits < 32)
        floor_dt = self.w_dtype if torch.finfo(self.w_dtype).bits < 32 \
            else self.work_dtype
        cg_floor = CG_FLOOR_MULT * float(torch.finfo(floor_dt).eps) \
            if narrow else 0.0
        stagnation = STAGNATION_WINDOW if narrow else 0

        cams, points = cams.to(self.dtype), points.to(self.dtype)
        blk = self.linearize(cams, points)
        obj, gnorm = blk.obj, blk.gnorm
        lam = 1e-3 * max(float(blk.Hcc.diagonal(dim1=1, dim2=2).max()),
                         float(blk.Hpp.diagonal(dim1=1, dim2=2).max()))
        gtol = atol + rtol * gnorm
        hist_obj, hist_gnorm, hist_cg = [], [], []
        naccepts, status = 0, 0
        for _ in range(max_iters):
            rtol_cg = max(min(max(math.sqrt(gnorm), 1e-10), 1e-2), cg_floor)
            dc, dp, Jd2, cg = self.step(blk, lam, rtol_cg, pcg_max,
                                        stagnation)
            gd = float(torch.sum(blk.g_c * dc) + torch.sum(blk.g_p * dp))
            dnorm = math.sqrt(float(torch.sum(dc * dc) + torch.sum(dp * dp)))
            xnorm = math.sqrt(float(torch.sum(cams * cams)
                                    + torch.sum(points * points)))
            obj_t = self.objective(cams + dc, points + dp)
            nan_step = not math.isfinite(dnorm)
            fatal = nan_step and lam > 1e20
            small_step = (not nan_step) and dnorm < satol + srtol * xnorm
            pred = -gd - 0.5 * Jd2
            ared = obj - obj_t
            accept = (pred > 0 and ared >= accept_ratio * pred
                      and math.isfinite(obj_t) and not nan_step)
            if accept:
                lam_new = max(lam / nu_d / (nu_d if ared >= good_ratio * pred
                                            else 1.0), lam_min)
            else:
                dsafe = dnorm if math.isfinite(dnorm) else math.inf
                lam_new = max(lam, 1.0 / max(dsafe, 1e-300)) * nu_m
            hist_obj.append(obj)
            hist_gnorm.append(gnorm)
            hist_cg.append(cg)
            if accept:
                cams, points = cams + dc, points + dp
                blk = self.linearize(cams, points)
                obj_n, gnorm_n = blk.obj, blk.gnorm
                naccepts += 1
            else:
                obj_n, gnorm_n = obj, gnorm
            obj_tol = oatol + ortol * abs(obj)
            small_obj = accept and obj - obj_n < obj_tol
            if narrow:
                small_obj = small_obj or (0 < pred < obj_tol
                                          and gnorm < 1e3 * gtol)
            if fatal:
                status = STATUS["exception"]
            elif small_step:
                status = STATUS["small_step"]
            elif gnorm_n < gtol:
                status = STATUS["first_order"]
            elif math.sqrt(2.0 * obj_n) < restol:
                status = STATUS["small_residual"]
            elif small_obj:
                status = STATUS["small_obj_change"]
            obj, gnorm, lam = obj_n, gnorm_n, lam_new
            if status:
                break
        else:
            status = STATUS["max_iter"]
        return Solve(cams, points, obj, gnorm, len(hist_obj), status,
                     naccepts, hist_obj, hist_gnorm, hist_cg)


def pcg(matvec, b, Minv, rtol: float, max_iters: int, stagnation: int):
    """Block-Jacobi preconditioned CG for ``S x = b`` from 0: stops at
    ``||r|| <= rtol ||b||``, after ``max_iters`` steps, on ``p'Sp <= 0``,
    or after ``stagnation`` steps (when > 0) without a 4% gain on the best
    residual. The start costs one matvec, as the solver's does."""

    def prec(v):
        return torch.einsum("cab,cb->ca", Minv, v)

    bnorm = float(torch.linalg.vector_norm(b))
    tol = rtol * (bnorm if bnorm != 0.0 else 1.0)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = prec(r)
    p, rz = z, float(torch.sum(r * z))
    r2 = best = float(torch.sum(r * r))
    down, stag, it = False, 0, 0
    while it < max_iters:
        # Written so that a NaN residual stops, as the solver's flag does.
        if down or not math.sqrt(r2) > tol or (stagnation
                                               and stag >= stagnation):
            break
        Sp = matvec(p)
        pSp = float(torch.sum(p * Sp))
        down = pSp <= 0.0
        alpha = 0.0 if down else rz / pSp
        x = x + alpha * p
        r = r - alpha * Sp
        z = prec(r)
        rz_new = float(torch.sum(r * z))
        p = z + (rz_new / rz if rz > 0 else 0.0) * p
        rz = rz_new
        r2 = float(torch.sum(r * r))
        stag = 0 if r2 < 0.96 * best else stag + 1
        best = min(best, r2)
        it += 1
    return x, it
