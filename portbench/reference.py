"""The plain reference of loop-closure verification: what `verify_many`
must answer for a candidate, worked out again from the world's keyframes
and the base key, in plain PyTorch and numpy. It imports nothing of the
program.

Per candidate (query keyframe q, target keyframe m):

1. Matching: 2-NN by Hamming distance over the target's observed features
   (the first of equal distances wins), kept when d1 < ratio * d2.
2. Stereo gate: 3d3d RANSAC, Arun's closed form on 3 matched landmarks
   per hypothesis, inliers ||q - (R p + t)|| < threshold, the first best
   hypothesis, a weighted re-solve on its inliers (used where it solves on
   >= 3 of them), the inliers of the re-solved model.
3. Mono gate: 2d2d RANSAC on bearings with the configuration's minimal
   solver, Sampson inliers below the threshold, the first best model,
   a weighted 8-point re-solve on its inliers projected onto the
   essential manifold (used where it solves on >= 8 of them), the inliers
   of the re-solved model.
     eight_point:   the least-squares essential matrix of 8 samples.
     stewenius_5pt: every real root of the 5-point problem (nullspace of
                    the 5 x 9 design, the ten cubic constraints reduced by
                    Gauss-Jordan, the eigenvectors of the action matrix of
                    x), every root scored on every point.
4. The pose of the target frame in the query frame: the inverse of the
   stereo model.

Hypotheses sample the same minimal sets as the program (the threefry
draws keyed by the candidate's address, Floyd's k-subset over the matched
features in index order): the RNG policy is part of what the program
promises, not a detail of it.

`precision="float64"` is the reference. `precision="tf32"` is the
control: float32 throughout, with the inputs of every matrix product
rounded to TF32's 10-bit mantissa (what a float32 product gives on the
card with TF32 on) and the small factorizations in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import threefry

_NO_MATCH = 512
_EPS = 1e-12


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name}")
        self.name = name
        self.dt = torch.float64 if name == "float64" else torch.float32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a matrix product in this precision."""
        x = x.to(self.dt)
        if self.name != "tf32":
            return x
        i = x.contiguous().view(torch.int32)
        i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)

    def mm(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *(self.r(x) for x in xs))


# ----------------------------------------------------------------- matching


def _bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) float bits."""
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                     device=desc.device)
    b = (desc[..., :, None] & w) > 0
    return b.reshape(*desc.shape[:-1], 256).to(torch.float32)


def match(desc_q, valid_q, desc_t, valid_t, ratio: float) -> torch.Tensor:
    """(S, K) int64 match table: target index or -1. Hamming distances as
    products of {0, 1} bits, exact in float32 (sums of at most 256)."""
    A, B = _bits(desc_q), _bits(desc_t)
    D = (A.sum(-1)[..., :, None] + B.sum(-1)[..., None, :]
         - 2.0 * torch.matmul(A, B.transpose(-1, -2))).round().long()
    D = torch.where(valid_t[:, None, :], D, _NO_MATCH)
    d1, i1 = torch.min(D, dim=-1)
    Kt = D.shape[-1]
    cols = torch.arange(Kt, device=D.device)
    i1 = torch.min(torch.where(D == d1[..., None], cols, Kt), dim=-1).values
    d2 = torch.min(torch.where(cols == i1[..., None], _NO_MATCH, D),
                   dim=-1).values
    ok = (valid_q & (d1.double() < ratio * d2.double()) & (d1 <= 256)
          & (d1 < _NO_MATCH))
    return torch.where(ok, i1, -1)


# ----------------------------------------------------------------- sampling


def sample_positions(key: np.ndarray, matched: np.ndarray, n_hyp: int,
                     k: int) -> tuple[np.ndarray, np.ndarray]:
    """Floyd's k-subset over the matched positions of each candidate.
    key (S, 2) uint32, matched (S, K) bool. Returns (positions (S, H, k)
    into the feature axis, distinct (S, H) bool)."""
    S, K = matched.shape
    m = matched.sum(1).astype(np.int32)
    order = np.argsort(~matched, axis=1, kind="stable")
    u = threefry.uniform(key, (n_hyp, k))            # (S, H, k) float32
    picks = []
    for j in range(k):
        hi = np.maximum(m - k + 1 + j, 1).astype(np.int32)
        t = (u[:, :, j] * hi.astype(np.float32)[:, None]).astype(np.int32)
        t = np.minimum(t, (hi - 1)[:, None])
        coll = np.zeros_like(t, bool)
        for prev in picks:
            coll |= prev == t
        picks.append(np.where(coll, (m - k + j)[:, None], t))
    picks = np.clip(np.stack(picks, -1), 0, K - 1)
    srt = np.sort(picks, -1)
    distinct = np.all(srt[..., 1:] != srt[..., :-1], -1)
    pos = np.take_along_axis(order, picks.reshape(S, -1), 1)
    return pos.reshape(picks.shape), distinct


def _take(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (S, K, 3), pos (S, H, k) -> (S, H, k, 3)."""
    S, H, k = pos.shape
    g = torch.gather(x, 1, pos.reshape(S, H * k, 1).expand(-1, -1, 3))
    return g.reshape(S, H, k, 3)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    mx = x.max(-1, keepdim=True).values
    ar = torch.arange(n, device=x.device)
    return torch.where(x == mx, ar, n).min(-1).values


# ----------------------------------------------------------- rigid (Arun)


def kabsch(P, Q, w, pr: Precision):
    """Weighted (R, t) minimising sum w ||q - (R p + t)||^2.
    P, Q (..., n, 3); w (..., n). Returns R (..., 3, 3), t (..., 3),
    ok (...,): the second singular value of the cross-covariance above
    1e-7 max(s1, 1)."""
    ws = torch.clamp(w.sum(-1, keepdim=True), min=_EPS)
    wn = (w / ws)[..., None]
    pbar = (P * wn).sum(-2)
    qbar = (Q * wn).sum(-2)
    pc, qc = P - pbar[..., None, :], Q - qbar[..., None, :]
    H = pr.mm((pc * wn).transpose(-1, -2), qc)      # sum w pc qc^T
    U, s, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    d = torch.sign(torch.det(pr.mm(V, U.transpose(-1, -2))))
    d = torch.where(d == 0, torch.ones_like(d), d)
    D = torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device)
    D[..., 2] = d
    R = pr.mm(V * D[..., None, :], U.transpose(-1, -2))
    t = qbar - pr.mm(R, pbar[..., None])[..., 0]
    ok = s[..., 1] > 1e-7 * torch.clamp(s[..., 0], min=1.0)
    return R, t, ok


def rigid_inliers(R, t, p, q, valid, thr: float, pr: Precision):
    """R (..., 3, 3), t (..., 3); p, q (S, K, 3) broadcast against the
    model's batch as (S, 1, K, 3) when R is (S, H, 3, 3)."""
    Rp = pr.mm(p, R.transpose(-1, -2))
    r = q - (Rp + t[..., None, :])
    return ((r * r).sum(-1) < thr * thr) & valid


def stereo_gate(key, p, q, matched, cfg, pr: Precision, block: int = 16):
    """3d3d RANSAC over S candidates. p: query landmarks (S, K, 3), q: the
    matched target landmarks (S, K, 3), matched (S, K) bool."""
    H, thr = cfg["ransac_hypotheses"], cfg["stereo_threshold"]
    pos, distinct = sample_positions(key, matched.cpu().numpy(), H, 3)
    pos = torch.from_numpy(pos).to(p.device)
    distinct = torch.from_numpy(distinct).to(p.device)
    Rb, tb = [], []
    for lo in range(0, p.shape[0], block):
        sl = slice(lo, lo + block)
        P, Q = _take(p[sl], pos[sl]), _take(q[sl], pos[sl])
        R_h, t_h, ok_h = kabsch(P, Q, torch.ones_like(P[..., 0]), pr)
        inl = rigid_inliers(R_h, t_h, p[sl, None], q[sl, None],
                            matched[sl, None], thr, pr)
        counts = inl.sum(-1) * (ok_h & distinct[sl])
        best = first_argmax(counts)
        ar = torch.arange(best.shape[0], device=p.device)
        Rb.append(R_h[ar, best])
        tb.append(t_h[ar, best])
    R_b, t_b = torch.cat(Rb), torch.cat(tb)
    inl = rigid_inliers(R_b, t_b, p, q, matched, thr, pr)
    R_r, t_r, ok_r = kabsch(p, q, inl.to(p.dtype), pr)
    use = ok_r & (inl.sum(-1) >= 3)
    R_b = torch.where(use[:, None, None], R_r, R_b)
    t_b = torch.where(use[:, None], t_r, t_b)
    n = rigid_inliers(R_b, t_b, p, q, matched, thr, pr).sum(-1)
    return {"ok": n >= cfg["min_stereo_inliers"], "n": n, "R": R_b,
            "t": t_b}


# ------------------------------------------------------- essential models


def project_essential(E, pr: Precision):
    """E (..., 3, 3) -> (u1 v1^T + u2 v2^T, ok: s2 > 1e-6 max(s1, eps))."""
    U, s, Vh = torch.linalg.svd(E)
    Ep = pr.mm(U[..., :, :2], Vh[..., :2, :])
    ok = s[..., 1] > 1e-6 * torch.clamp(s[..., 0], min=_EPS)
    return Ep, ok


def sampson(E, f1, f2, pr: Precision):
    """Squared Sampson errors: E (..., 3, 3), f1 f2 (..., K, 3)."""
    Ef1 = pr.mm(f1, E.transpose(-1, -2))      # rows (E f1)^T
    Etf2 = pr.mm(f2, E)                       # rows (E^T f2)^T
    num = (f2 * Ef1).sum(-1)
    den = (Ef1[..., 0] ** 2 + Ef1[..., 1] ** 2 + Etf2[..., 0] ** 2
           + Etf2[..., 1] ** 2)
    return num * num / torch.clamp(den, min=_EPS)


def _design(f1, f2):
    """Rows outer(f2, f1).ravel(): (..., n, 9)."""
    return (f2[..., :, None] * f1[..., None, :]).flatten(-2)


def eight_point(f1, f2, w, pr: Precision):
    """Weighted least-squares essential matrix of (..., n, 3) bearings,
    projected. Returns (E (..., 3, 3), ok)."""
    A = _design(f1, f2)
    N = pr.mm((A * w[..., None]).transpose(-1, -2), A)
    _, V = torch.linalg.eigh(N)
    return project_essential(V[..., :, 0].reshape(*N.shape[:-2], 3, 3), pr)


# exponent tuples of the monomials in x, y, z up to degree 3: the ten
# cubics first, then the ten standard monomials that span the quotient
_CUBIC = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
          (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
          (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONO3 = _CUBIC + _BASIS
_MONO1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONO2 = [m for m in _MONO3 if sum(m) <= 2]


def _product_table(a_list, b_list, c_list) -> np.ndarray:
    T = np.zeros((len(a_list), len(b_list), len(c_list)))
    for i, a in enumerate(a_list):
        for j, b in enumerate(b_list):
            T[i, j, c_list.index(tuple(x + y for x, y in zip(a, b)))] = 1
    return T


_T11 = _product_table(_MONO1, _MONO1, _MONO2)
_T21 = _product_table(_MONO2, _MONO1, _MONO3)


def _action_x() -> tuple[np.ndarray, np.ndarray]:
    """For each standard monomial b, x b as (cubic row to substitute, or
    -1) and (standard column, or -1)."""
    sub, col = [], []
    for b in _BASIS:
        xb = (b[0] + 1, b[1], b[2])
        if xb in _CUBIC:
            sub.append(_CUBIC.index(xb))
            col.append(-1)
        else:
            sub.append(-1)
            col.append(_BASIS.index(xb))
    return np.array(sub), np.array(col)


_SUB, _COL = _action_x()


def five_point(f1, f2, pr: Precision):
    """Every real root of the 5-point problem. f1, f2 (..., 5, 3).
    Returns (E (..., 10, 3, 3) projected, ok (..., 10))."""
    dev, dt = f1.device, pr.dt
    batch = f1.shape[:-2]
    A = _design(f1, f2).reshape(-1, 5, 9)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    basis = Vh[:, 5:, :]                           # X, Y, Z, W (n, 4, 9)
    E1 = basis.permute(0, 2, 1).reshape(-1, 3, 3, 4)   # E = xX + yY + zZ + W
    T11 = torch.as_tensor(_T11, dtype=dt, device=dev)
    T21 = torch.as_tensor(_T21, dtype=dt, device=dev)

    def mul11(a, b):
        return pr.einsum("...a,...b,abc->...c", a, b, T11)

    def mul21(a, b):
        return pr.einsum("...a,...b,abc->...c", a, b, T21)

    EEt = sum(mul11(E1[:, :, None, k], E1[:, None, :, k]) for k in range(3))
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    EEtE = sum(mul21(EEt[:, :, None, k], E1[:, None, k, :])
               for k in range(3))
    trE = mul21(tr[:, None, None, :].expand(-1, 3, 3, -1), E1)
    C = (2 * EEtE - trE).reshape(-1, 9, 20)
    e = E1
    minor = lambda a, b, c, d: mul11(e[:, a[0], a[1]], e[:, b[0], b[1]]) \
        - mul11(e[:, c[0], c[1]], e[:, d[0], d[1]])
    det = (mul21(minor((1, 1), (2, 2), (1, 2), (2, 1)), e[:, 0, 0])
           - mul21(minor((1, 0), (2, 2), (1, 2), (2, 0)), e[:, 0, 1])
           + mul21(minor((1, 0), (2, 1), (1, 1), (2, 0)), e[:, 0, 2]))
    M = torch.cat([C, det[:, None]], 1)            # (n, 10, 20)
    G, info = torch.linalg.solve_ex(M[:, :, :10], M[:, :, 10:])
    sub = torch.as_tensor(_SUB, device=dev)
    col = torch.as_tensor(_COL, device=dev)
    act = torch.zeros(G.shape, dtype=dt, device=dev)
    for r in range(10):
        if sub[r] >= 0:
            act[:, r] = -G[:, sub[r]]
        else:
            act[:, r, col[r]] = 1.0
    fin = torch.isfinite(act).flatten(1).all(1) & (info == 0)
    act = torch.where(fin[:, None, None], act, torch.eye(10, dtype=dt,
                                                         device=dev))
    # the eigenproblem of the small action matrices on the host
    lam, vec = torch.linalg.eig(act.cpu())
    lam, vec = lam.to(dev), vec.to(dev)
    one = vec[:, 9, :]
    xyz = vec[:, 6:9, :] / torch.where(one.abs() > 0, one,
                                       torch.ones_like(one))[:, None, :]
    real = ((lam.imag.abs() <= 1e-6 * torch.clamp(lam.abs(), min=1.0))
            & (one.abs() > 1e-12) & fin[:, None])
    x, y, z = (xyz[:, i].real.to(dt) for i in range(3))   # (n, 10)
    coef = torch.stack([x, y, z, torch.ones_like(x)], -1)  # (n, 10, 4)
    E = pr.einsum("nrc,nijc->nrij", coef, E1)
    E = E / torch.clamp(E.flatten(-2).norm(dim=-1), min=_EPS)[..., None,
                                                                None]
    E, okp = project_essential(E, pr)
    ok = real & okp & torch.isfinite(E).flatten(-2).all(-1)
    E = torch.where(ok[..., None, None], E, torch.zeros_like(E))
    return E.reshape(*batch, 10, 3, 3), ok.reshape(*batch, 10)


def mono_gate(key, f1, f2, matched, cfg, pr: Precision, block: int = 16):
    """2d2d RANSAC over S candidates. f1: query bearings (S, K, 3), f2:
    the matched target bearings (S, K, 3), matched (S, K) bool."""
    H, thr = cfg["ransac_hypotheses"], cfg["mono_threshold"]
    solver = cfg["mono_solver"]
    k = {"stewenius_5pt": 5, "eight_point": 8}[solver]
    pos, distinct = sample_positions(key, matched.cpu().numpy(), H, k)
    pos = torch.from_numpy(pos).to(f1.device)
    distinct = torch.from_numpy(distinct).to(f1.device)
    Eb = []
    for lo in range(0, f1.shape[0], block):
        sl = slice(lo, lo + block)
        a, b = _take(f1[sl], pos[sl]), _take(f2[sl], pos[sl])
        if k == 5:
            E_h, ok_h = five_point(a, b, pr)                # (s, H, 10, ...)
            E_h, ok_h = E_h.flatten(1, 2), ok_h.flatten(1, 2)
            ok_h = ok_h & distinct[sl].repeat_interleave(10, dim=1)
        else:
            E_h, ok_h = eight_point(a, b, torch.ones_like(a[..., 0]), pr)
            ok_h = ok_h & distinct[sl]
        err = sampson(E_h, f1[sl, None], f2[sl, None], pr)
        counts = ((err < thr) & matched[sl, None]).sum(-1) * ok_h
        best = first_argmax(counts)
        Eb.append(E_h[torch.arange(best.shape[0], device=f1.device), best])
    E_b = torch.cat(Eb)
    inl = (sampson(E_b, f1, f2, pr) < thr) & matched
    E_r, ok_r = eight_point(f1, f2, inl.to(f1.dtype), pr)
    use = ok_r & (inl.sum(-1) >= 8)
    E_b = torch.where(use[:, None, None], E_r, E_b)
    n = ((sampson(E_b, f1, f2, pr) < thr) & matched).sum(-1)
    return {"ok": n >= cfg["min_mono_inliers"], "n": n}


# ------------------------------------------------------------------- entry


@torch.no_grad()
def verify(world, cfg: dict, base_key: np.ndarray, qr, qf, tr, tm,
           precision: str = "float64", device="cpu", block: int = 16):
    """What `verify_many` must answer for candidates (qr, qf, tr, tm)
    (each (S,) integers) of `world` under configuration `cfg` and the
    base key. Returns numpy arrays: match (S, K), mono_ok, stereo_ok,
    mono_inliers, stereo_inliers (S,), R (S, 3, 3), t (S, 3): the pose of
    the target frame in the query frame."""
    pr = Precision(precision)
    dev = torch.device(device)
    qr, qf, tr, tm = (np.asarray(a, np.int64) for a in (qr, qf, tr, tm))

    def get(a, r, f, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a[r, f])).to(dev)
        return x if dtype is None else x.to(dtype)

    m = match(get(world.descriptors, qr, qf), get(world.obs_valid, qr, qf),
              get(world.descriptors, tr, tm), get(world.obs_valid, tr, tm),
              cfg["lowe_ratio"])
    matched = m >= 0
    idx = torch.clamp(m, min=0)

    def matched_target(a):
        x = get(a, tr, tm, pr.dt)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))

    keys = threefry.derive(
        np.broadcast_to(base_key, (len(qr), 2)), qr, qf, tr, tm)
    kmono = threefry.derive(keys, 0)
    kst = threefry.derive(keys, 1)
    mono = mono_gate(kmono, get(world.bearings, qr, qf, pr.dt),
                     matched_target(world.bearings), matched, cfg, pr, block)
    st = stereo_gate(kst, get(world.landmarks, qr, qf, pr.dt),
                     matched_target(world.landmarks), matched, cfg, pr,
                     block)
    Rt = st["R"].transpose(-1, -2)
    t_inv = -pr.mm(Rt, st["t"][..., None])[..., 0]
    out = {"match": m, "mono_ok": mono["ok"], "stereo_ok": st["ok"],
           "mono_inliers": mono["n"], "stereo_inliers": st["n"],
           "R": Rt, "t": t_inv}
    return {k: v.cpu().numpy() for k, v in out.items()}
