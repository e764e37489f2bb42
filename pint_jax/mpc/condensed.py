"""Condensed-QP construction for linear-dynamics MPC.

Builds, on host in float64, the condensed quadratic program of a
box-constrained linear MPC problem, then quantizes it into the int8/int32
fixed-point operands the device solver consumes.

No counterpart exists in the reference library (SURVEY.md section 2.4): the
MPC stack is the BASELINE.json capability layer sitting on top of the SWAR
substrate.  The quantization choices follow the integer arithmetic the
device runs:

* the Hessian is int8 (int8 x int8 -> int32 matmuls),
* the gradient offset and iterate math are int32,
* the control iterate itself lives as int8 lanes packed 4-per-uint32 word,
  updated with the saturating packed ops -- the int8 saturation boundary IS
  the box constraint after scaling.

Condensation (standard): with x_{k+1} = A x_k + B u_k,

    X = A_bar x0 + B_bar U
    J(U) = 1/2 U^T H U + g(x0)^T U + const
    H = B_bar^T Q_bar B_bar + R_bar
    g(x0) = B_bar^T Q_bar (A_bar x0 - X_ref)

Box u_k in [-u_max, u_max] maps exactly onto the int8 lane range [-127, 127]
via u_scale = u_max / 127.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CondensedQP",
    "QuantizedQP",
    "condense_lti",
    "condense_ltv",
    "condense_ltv_batch",
    "condense_double_integrator",
    "dare_terminal",
    "quantize",
]


@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Float64 condensed QP: minimize 1/2 U^T H U + g^T U, |U| <= u_max.

    ``g_from_x0`` maps an initial state to the linear term:
    g = G x0 + g_ref."""

    H: np.ndarray          # (T, T)
    G: np.ndarray          # (T, n)  g(x0) = G @ x0 + g_ref
    g_ref: np.ndarray      # (T,)
    u_max: float
    lipschitz: float       # lambda_max(H)

    def gradient(self, U: np.ndarray, x0: np.ndarray) -> np.ndarray:
        return U @ self.H.T + x0 @ self.G.T + self.g_ref

    def solve_pgd(
        self, x0: np.ndarray, iters: int, step: Optional[float] = None
    ) -> np.ndarray:
        """Float64 projected gradient descent; batched over leading dims of
        x0.  This is the CPU reference the quantized solver is checked
        against (same iteration count and step)."""
        x0 = np.asarray(x0, dtype=np.float64)
        alpha = step if step is not None else 1.0 / self.lipschitz
        U = np.zeros(x0.shape[:-1] + (self.H.shape[0],), dtype=np.float64)
        for _ in range(iters):
            U = U - alpha * self.gradient(U, x0)
            U = np.clip(U, -self.u_max, self.u_max)
        return U


@dataclasses.dataclass(frozen=True)
class QuantizedQP:
    """Fixed-point operands for the device PGD solver.

    Scaling model (all scales are powers of two where it matters):

      U_phys = U_lane * u_scale                 (int8 lanes)
      H_q    = round(alpha * H / h_scale)       (int8, |.| <= 127)
      step direction: d_lane = -(U_lane @ H_q^T * h_scale + g_q) >> g_shift

    where g_q = round(alpha * g / (u_scale * 2^-g_shift)) pre-folds alpha and
    the output scale so the inner loop is one int8 matmul, one int32 add and
    one shift before the saturating packed update.
    """

    qp: CondensedQP
    Hq: np.ndarray         # (Tp, Tp) int8, zero-padded to a multiple of pad_to
    h_scale: float         # alpha*H ~ Hq * h_scale
    g_shift: int
    Gq_scale: float        # g_q = (G @ x0 + g_ref) * glin_scale (int32)
    u_scale: float
    horizon: int           # T (unpadded)
    padded: int            # Tp
    hs_num: int            # (acc * hs_num) >> hs_den ~ acc * h_scale * 2^g_shift
    hs_den: int

    def g_lane_fixed(self, x0_phys: np.ndarray) -> np.ndarray:
        """int32 linear term in pre-shifted lane units for given states."""
        g = x0_phys @ self.qp.G.T + self.qp.g_ref  # (B, T) float64
        # non-finite states (serving-path corruption) quantize to saturated
        # linear terms instead of raising / UB int casts
        g = np.nan_to_num(g * self.Gq_scale, posinf=2**31 - 1, neginf=-(2**31))
        gq = np.round(g).astype(np.int64)
        pad = self.padded - self.horizon
        if pad:
            gq = np.concatenate(
                [gq, np.zeros(gq.shape[:-1] + (pad,), np.int64)], axis=-1
            )
        return np.clip(gq, -(2**31), 2**31 - 1).astype(np.int32)


def condense_lti(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R,
    Qf: np.ndarray,
    T: int,
    x_ref: np.ndarray,
    u_max: float,
) -> CondensedQP:
    """Condense a box-constrained LTI MPC problem.

    x_{k+1} = A x_k + B u_k with A (n, n), B (n, m); cost
    sum_k (x_k - x_ref)^T Q (x_k - x_ref) + u_k^T R u_k (terminal Qf),
    box |u| <= u_max per input.  The decision vector flattens time-major:
    U = [u_0; u_1; ...] of length T*m -- the layout the packed int8
    solvers consume directly.
    """
    A = np.atleast_2d(np.asarray(A, float))
    B = np.asarray(B, float).reshape(A.shape[0], -1)
    n, m = B.shape
    R = np.eye(m) * R if np.isscalar(R) else np.asarray(R, float)
    # A_bar: stacked powers; B_bar[k] maps U -> x_{k+1}
    Abar = np.zeros((T, n, n))
    Bbar = np.zeros((T, n, T * m))
    Ak = np.eye(n)
    for k in range(T):
        Ak = Ak @ A          # A^(k+1)
        Abar[k] = Ak
        for j in range(k + 1):
            Bbar[k, :, j * m : (j + 1) * m] = (
                np.linalg.matrix_power(A, k - j) @ B
            )
    # block-diagonal weights over stacked states
    Qs = [Q] * (T - 1) + [Qf]
    H = np.zeros((T * m, T * m))
    Gg = np.zeros((T * m, n))
    g_ref = np.zeros(T * m)
    for k in range(T):
        Qk = Qs[k]
        H += Bbar[k].T @ Qk @ Bbar[k]
        Gg += Bbar[k].T @ Qk @ Abar[k]
        g_ref += -Bbar[k].T @ Qk @ x_ref
    H += np.kron(np.eye(T), R)
    lip = float(np.linalg.eigvalsh(H).max())
    return CondensedQP(H=H, G=Gg, g_ref=g_ref, u_max=u_max, lipschitz=lip)


# backward-compatible private alias
_condense = condense_lti


def condense_ltv(
    A_seq: np.ndarray,
    B_seq: np.ndarray,
    c_seq: Optional[np.ndarray],
    Q: np.ndarray,
    R,
    Qf: np.ndarray,
    x_ref,
    u_max: float,
) -> CondensedQP:
    """Condense a box-constrained **time-varying affine** MPC problem.

    x_{k+1} = A_k x_k + B_k u_k + c_k with A_seq (T, n, n), B_seq (T, n, m),
    c_seq (T, n) or None; cost sum_k (x_{k+1} - x_ref_k)^T Q (...) +
    u_k^T R u_k with terminal Qf; x_ref is (n,) or (T, n) (per-step targets
    for x_1..x_T).  This is the SQP inner problem: A/B/c come from
    linearizing nonlinear dynamics along a nominal trajectory in **absolute**
    controls (c_k = f(xbar_k, ubar_k) - A_k xbar_k - B_k ubar_k), which keeps
    the box symmetric -- |u| <= u_max maps onto int8 lane saturation exactly
    as in the LTI path.

    Propagation is the forward recursion
    Abar_k = A_k Abar_{k-1}, Bbar_k = A_k Bbar_{k-1} + [0..B_k..0],
    Cbar_k = A_k Cbar_{k-1} + c_k; with constant A, B and c = 0 this agrees
    with :func:`condense_lti` (tests/test_ltv.py checks it numerically).
    """
    A_seq = np.asarray(A_seq, float)
    B_seq = np.asarray(B_seq, float)
    T, n, m = B_seq.shape
    if A_seq.shape != (T, n, n):
        raise ValueError(f"A_seq {A_seq.shape} vs B_seq {B_seq.shape}")
    c_seq = (
        np.zeros((T, n)) if c_seq is None else np.asarray(c_seq, float)
    )
    x_ref = np.asarray(x_ref, float)
    x_ref_seq = np.broadcast_to(x_ref, (T, n)) if x_ref.ndim == 1 else x_ref
    R = np.eye(m) * R if np.isscalar(R) else np.asarray(R, float)

    Abar = np.empty((T, n, n))
    Bbar = np.zeros((T, n, T * m))
    Cbar = np.empty((T, n))
    Ak_prod = np.eye(n)
    c_acc = np.zeros(n)
    for k in range(T):
        Ak_prod = A_seq[k] @ Ak_prod
        Abar[k] = Ak_prod
        if k:
            Bbar[k] = A_seq[k] @ Bbar[k - 1]
        Bbar[k, :, k * m : (k + 1) * m] = B_seq[k]
        c_acc = A_seq[k] @ c_acc + c_seq[k]
        Cbar[k] = c_acc

    Qs = [Q] * (T - 1) + [Qf]
    H = np.kron(np.eye(T), R)
    Gg = np.zeros((T * m, n))
    g_ref = np.zeros(T * m)
    for k in range(T):
        BtQ = Bbar[k].T @ Qs[k]
        H += BtQ @ Bbar[k]
        Gg += BtQ @ Abar[k]
        g_ref += BtQ @ (Cbar[k] - x_ref_seq[k])
    lip = float(np.linalg.eigvalsh(H).max())
    return CondensedQP(H=H, G=Gg, g_ref=g_ref, u_max=u_max, lipschitz=lip)


def condense_ltv_batch(
    A_seq: np.ndarray,
    B_seq: np.ndarray,
    c_seq: Optional[np.ndarray],
    Q: np.ndarray,
    R,
    Qf: np.ndarray,
    x_ref,
    return_propagators: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Batched :func:`condense_ltv`: one condensation per problem, the time
    recursion shared and every per-step product a batched GEMM.

    A_seq (B, T, n, n), B_seq (B, T, n, m), c_seq (B, T, n) or None;
    x_ref (n,) or (T, n), shared across the batch.  Returns
    ``(H (B,Tm,Tm), G (B,Tm,n), g_ref (B,Tm), lipschitz (B,))`` with
    per-problem values matching the scalar function to float rounding
    (the per-k accumulation order is identical; only the GEMM batching
    differs).  This is the SQP host-side hot path: ~40x faster than a
    per-problem Python loop at batch 256.

    With ``return_propagators=True`` the per-step propagators are appended:
    ``(..., Abar (B,T,n,n), Bbar (B,T,n,Tm), Cbar (B,T,n))`` where
    x_{k+1} = Abar_k x0 + Bbar_k U + Cbar_k -- the inputs state-constraint
    stacking needs (mpc/constrained.py, mpc/sqp_constrained.py).
    """
    A_seq = np.asarray(A_seq, float)
    B_seq = np.asarray(B_seq, float)
    Bb, T, n, m = B_seq.shape
    c_seq = (
        np.zeros((Bb, T, n)) if c_seq is None else np.asarray(c_seq, float)
    )
    x_ref = np.asarray(x_ref, float)
    x_ref_seq = np.broadcast_to(x_ref, (T, n)) if x_ref.ndim == 1 else x_ref
    R = np.eye(m) * R if np.isscalar(R) else np.asarray(R, float)
    Q = np.asarray(Q, float)
    Qf = np.asarray(Qf, float)

    Tm = T * m
    # forward recursion (sequential in k, batched over problems), storing
    # the per-step propagators so the weighted accumulations below become
    # three big optimized einsums instead of T temp-allocating GEMMs
    Abar = np.empty((Bb, T, n, n))
    Bbar_all = np.empty((Bb, T, n, Tm))
    Cbar_all = np.empty((Bb, T, n))
    Cx = np.empty((Bb, T, n))        # Cbar_k - x_ref_k
    Ak_prod = np.zeros((Bb, n, n))
    Ak_prod[:] = np.eye(n)
    Bbar = np.zeros((Bb, n, Tm))
    c_acc = np.zeros((Bb, n))
    for k in range(T):
        Ak = A_seq[:, k]
        Ak_prod = Ak @ Ak_prod
        if k:
            Bbar = Ak @ Bbar
        Bbar[:, :, k * m : (k + 1) * m] = B_seq[:, k]
        c_acc = np.einsum("bij,bj->bi", Ak, c_acc) + c_seq[:, k]
        Abar[:, k] = Ak_prod
        Bbar_all[:, k] = Bbar
        Cbar_all[:, k] = c_acc
        Cx[:, k] = c_acc - x_ref_seq[k]

    H = np.zeros((Bb, Tm, Tm))
    H[:] = np.kron(np.eye(T), R)
    # shared Q over all steps plus a terminal (Qf - Q) correction
    dQ = Qf - Q
    BQ = np.einsum("bkin,ij->bkjn", Bbar_all, Q, optimize=True)
    BT = Bbar_all[:, T - 1]
    BQT = np.einsum("bin,ij->bjn", BT, dQ, optimize=True)
    H += np.einsum("bkjn,bkjm->bnm", BQ, Bbar_all, optimize=True)
    H += np.einsum("bjn,bjm->bnm", BQT, BT, optimize=True)
    G = np.einsum("bkjn,bkjq->bnq", BQ, Abar, optimize=True)
    G += np.einsum("bjn,bjq->bnq", BQT, Abar[:, T - 1], optimize=True)
    g_ref = np.einsum("bkjn,bkj->bn", BQ, Cx, optimize=True)
    g_ref += np.einsum("bjn,bj->bn", BQT, Cx[:, T - 1], optimize=True)
    lip = np.linalg.eigvalsh(H)[:, -1]
    if return_propagators:
        return H, G, g_ref, lip, Abar, Bbar_all, Cbar_all
    return H, G, g_ref, lip


def dare_terminal(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R,
    iters: int = 1000,
    tol: float = 1e-10,
) -> np.ndarray:
    """Terminal weight P from the discrete algebraic Riccati equation.

    Fixed-point iteration of
    P <- Q + A^T (P - P B (R + B^T P B)^-1 B^T P) A.
    Using P as the MPC terminal cost (instead of a heuristic qf_scale * Q)
    makes the finite-horizon controller inherit the infinite-horizon LQR's
    stability margin, which is what lets regulation horizons stay SHORT --
    the regime where condensation of unstable plants is well-conditioned
    and the fixed-point PGD converges in tens of iterations.

    For nonlinear models, call with the linearization at the operating
    point (e.g. ``model.linearize(x_ref, u=0)`` scaled to lane units).
    """
    A = np.atleast_2d(np.asarray(A, float))
    B = np.asarray(B, float).reshape(A.shape[0], -1)
    m = B.shape[1]
    R = np.eye(m) * R if np.isscalar(R) else np.asarray(R, float)
    Q = np.asarray(Q, float)
    P = Q.copy()
    for _ in range(iters):
        BtP = B.T @ P
        K = np.linalg.solve(R + BtP @ B, BtP @ A)
        P_next = Q + A.T @ P @ (A - B @ K)
        P_next = 0.5 * (P_next + P_next.T)
        if not np.isfinite(P_next).all() or np.abs(P_next).max() > 1e12:
            break  # diverging: unstabilizable pair
        if np.abs(P_next - P).max() < tol * max(1.0, np.abs(P).max()):
            return P_next
        P = P_next
    raise ValueError(
        "DARE iteration did not converge: the linearized pair (A, B) may "
        "not be stabilizable within the control budget"
    )


def condense_double_integrator(
    T: int = 50,
    dt: float = 1.0 / 32.0,
    q_pos: float = 1.0,
    q_vel: float = 0.1,
    r: float = 0.01,
    qf_scale: float = 10.0,
    u_max: float = 1.0,
    x_ref: Tuple[float, float] = (0.0, 0.0),
) -> CondensedQP:
    """Condensed QP for the exactly-discretized 1-D double integrator
    (matches pint_jax.models.DoubleIntegrator's discrete map)."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    Q = np.diag([q_pos, q_vel])
    Qf = qf_scale * Q
    return _condense(A, B, Q, r, Qf, T, np.asarray(x_ref, float), u_max)


def quantize(
    qp: CondensedQP,
    iters_step: Optional[float] = None,
    g_shift: int = 12,
    pad_to: int = 64,
) -> QuantizedQP:
    """Quantize a condensed QP for the int8 PGD solver.

    ``g_shift`` sets the fixed-point resolution of the step direction: the
    int32 pre-shift accumulator carries 2^g_shift sub-lane resolution, so
    gradient steps smaller than one int8 lane unit still accumulate across
    iterations (dithering-free but biased toward zero; adequate for PGD
    whose fixed points are at the box boundary or interior stationarity).
    """
    T = qp.H.shape[0]
    Tp = -(-T // pad_to) * pad_to
    alpha = iters_step if iters_step is not None else 1.0 / qp.lipschitz
    u_scale = qp.u_max / 127.0

    aH = alpha * qp.H  # dimensionless (maps lane units to lane units)
    h_scale = float(np.abs(aH).max()) / 127.0
    Hq = np.zeros((Tp, Tp), dtype=np.int8)
    Hq[:T, :T] = np.round(aH / h_scale).astype(np.int8)

    # d_pre = -(U_lane @ aH^T / u... ) in lane units * 2^g_shift:
    #   lane_delta_pre = -(U_lane @ Hq^T) * h_scale * 2^g_shift  - g_pre
    # we fold h_scale*2^g_shift into an int ratio applied in int32:
    #   hs_num / 2^hs_den ~ h_scale * 2^g_shift  (power-of-two friendly)
    # and the linear term g(x0) in the same pre-shift lane units:
    #   g_pre = alpha * g_phys / u_scale * 2^g_shift
    Gq_scale = alpha / u_scale * float(2**g_shift)

    # integer ratio for the matmul-accumulator rescale: pick the largest
    # hs_den such that |acc| * hs_num cannot overflow int32
    # (|acc| <= 127*127*Tp from the int8 matmul)
    val = h_scale * float(2**g_shift)
    acc_max = 127 * 127 * Tp
    num_max = (2**31 - 1) // acc_max
    # hs_den is an int32 arithmetic-shift amount: it must stay in [0, 31]
    hs_den = max(0, min(31, int(np.floor(np.log2(num_max / val)))))
    hs_num = int(round(val * 2**hs_den))
    if hs_num < 1:
        raise ValueError(
            f"step scale {val!r} cannot be represented as an int32 rational "
            "(problem scaling is degenerate); rescale the QP or raise g_shift"
        )
    if hs_num > num_max:
        raise ValueError(
            f"step scale {val!r} overflows the int32 accumulator budget "
            f"(hs_num={hs_num} > {num_max}); lower g_shift or rescale"
        )

    return QuantizedQP(
        qp=qp,
        Hq=Hq,
        h_scale=h_scale,
        g_shift=g_shift,
        Gq_scale=Gq_scale,
        u_scale=u_scale,
        horizon=T,
        padded=Tp,
        hs_num=hs_num,
        hs_den=hs_den,
    )
