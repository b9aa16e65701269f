"""MPC primitives for secure aggregation (Turbo-Aggregate): a numpy copy of
``fedml_tpu/core/mpc.py``, the whole module, since the port imports
nothing of ``fedml_tpu``.

Parity target: reference fedml_api/distributed/turboaggregate/mpc_function.py
(identical library in fedml_api/standalone/turboaggregate/) —
- Shamir/BGW secret sharing (BGW_encoding:62 / BGW_decoding:90),
- Lagrange Coded Computing (LCC_encoding:111 / LCC_decoding:195 and the
  _with_points variants :227,:249),
- additive secret sharing (Gen_Additive_SS:214),
- Diffie-Hellman key agreement (my_pk_gen:263 / my_key_agreement:271).

Redesign notes (same math, safer numerics): the reference evaluates
``alpha ** t`` before reducing mod p — silent int64 overflow for larger
degrees. Here every multiply is reduced mod p immediately (p < 2^31 keeps
products < 2^62), modular inverses use Fermat via ``pow(a, p-2, p)``, and
share generation is a Vandermonde-style matmul built with running powers.
These are host-side (numpy) by design: secure aggregation is a *protocol*
between trust domains, not a device kernel; the field arithmetic is cheap
relative to the masked-model transfers it protects.
"""

from __future__ import annotations

import numpy as np

# 2^31 - 1 (Mersenne prime) — keeps all products within int64.
DEFAULT_PRIME = 2147483647


def modular_inv(a, p: int = DEFAULT_PRIME):
    """Inverse mod prime p (Fermat little theorem; reference :4-18 uses
    extended Euclid — same result)."""
    a = np.mod(np.asarray(a, dtype=np.int64), p)
    return np.vectorize(lambda v: pow(int(v), p - 2, p))(a).astype(np.int64)


def field_div(num, den, p: int = DEFAULT_PRIME):
    """num / den mod p (reference divmod :21-27)."""
    num = np.mod(np.asarray(num, np.int64), p)
    return np.mod(num * modular_inv(den, p), p)


def _powers(points: np.ndarray, deg: int, p: int) -> np.ndarray:
    """[len(points), deg+1] matrix of points**t mod p with running products
    (no un-reduced exponentials, unlike reference :74)."""
    points = np.mod(np.asarray(points, np.int64), p)
    out = np.ones((len(points), deg + 1), np.int64)
    for t in range(1, deg + 1):
        out[:, t] = np.mod(out[:, t - 1] * points, p)
    return out


def lagrange_coeffs(alpha_s, beta_s, p: int = DEFAULT_PRIME) -> np.ndarray:
    """U[j, i] = ∏_{k≠i} (alpha_j − beta_k) / (beta_i − beta_k) mod p
    (reference gen_Lagrange_coeffs :39-59)."""
    alpha_s = np.mod(np.asarray(alpha_s, np.int64), p)
    beta_s = np.mod(np.asarray(beta_s, np.int64), p)
    U = np.zeros((len(alpha_s), len(beta_s)), np.int64)
    for i in range(len(beta_s)):
        den = np.int64(1)
        for k in range(len(beta_s)):
            if k != i:
                den = np.mod(den * np.mod(beta_s[i] - beta_s[k], p), p)
        for j in range(len(alpha_s)):
            num = np.int64(1)
            for k in range(len(beta_s)):
                if k != i:
                    num = np.mod(num * np.mod(alpha_s[j] - beta_s[k], p), p)
            U[j, i] = field_div(num, den, p)
    return U


def _mod_matmul(U: np.ndarray, flat: np.ndarray, p: int) -> np.ndarray:
    """U @ flat with every term reduced mod p — a plain int64 matmul of
    field elements overflows at ≥3 accumulated products ((p−1)² ≈ 4.6e18)."""
    out = np.zeros((U.shape[0], flat.shape[1]), np.int64)
    for i in range(U.shape[1]):
        out = np.mod(out + U[:, i, None] * flat[i][None], p)
    return out


# ---------------------------------------------------------------------------
# BGW / Shamir
# ---------------------------------------------------------------------------

def bgw_encode(X, N: int, T: int, p: int = DEFAULT_PRIME,
               rng: np.random.RandomState = None) -> np.ndarray:
    """Degree-T Shamir shares of ``X [m, d]`` for N workers, evaluation
    points alpha = 1..N (reference BGW_encoding :62-75). Returns [N, m, d]."""
    rng = rng or np.random.RandomState()
    X = np.mod(np.asarray(X, np.int64), p)
    m, d = X.shape
    coeffs = rng.randint(0, p, size=(T + 1, m, d)).astype(np.int64)
    coeffs[0] = X
    V = _powers(np.arange(1, N + 1), T, p)  # [N, T+1]
    shares = _mod_matmul(V, coeffs.reshape(T + 1, -1), p)
    return shares.reshape(N, m, d)


def bgw_decode(shares: np.ndarray, worker_idx, p: int = DEFAULT_PRIME,
               T: int | None = None):
    """Reconstruct the secret from ≥T+1 shares; ``worker_idx`` are the
    0-based worker indices the shares came from (reference BGW_decoding
    :90-108, evaluation point of worker i is i+1). Pass ``T`` to validate
    the share count — with < T+1 shares Lagrange interpolation returns a
    plausible-looking but WRONG reconstruction, so the check must be loud."""
    worker_idx = np.asarray(worker_idx, np.int64)
    if T is not None and len(worker_idx) < T + 1:
        raise ValueError(
            f"bgw_decode needs >= T+1 = {T + 1} shares, got {len(worker_idx)}"
        )
    alpha_eval = np.mod(worker_idx + 1, p)
    lam = lagrange_coeffs(np.zeros(1, np.int64), alpha_eval, p)[0]  # at x=0
    flat = shares.reshape(len(worker_idx), -1)
    rec = np.zeros(flat.shape[1], np.int64)
    for i in range(len(worker_idx)):
        rec = np.mod(rec + lam[i] * flat[i], p)
    return rec.reshape(shares.shape[1:])


# ---------------------------------------------------------------------------
# Lagrange Coded Computing
# ---------------------------------------------------------------------------

def _lcc_points(N: int, K: int, T: int, p: int):
    """Interpolation points beta (data+noise chunks) and evaluation points
    alpha (workers). The sets MUST be disjoint: a worker whose alpha equals
    some beta_k (k < K) would receive that plaintext chunk as its "share",
    voiding the T-noise privacy guarantee. beta = 0..K+T-1,
    alpha = K+T..K+T+N-1 (requires K+T+N < p, trivially true here)."""
    n_beta = K + T
    if n_beta + N >= p:
        # Privacy-critical (a collision hands a worker a plaintext chunk);
        # must survive python -O, so not an assert.
        raise ValueError(
            f"field p={p} too small for disjoint LCC point sets "
            f"(need K+T+N={n_beta + N} < p)")
    beta_s = np.arange(n_beta, dtype=np.int64)
    alpha_s = np.arange(n_beta, n_beta + N, dtype=np.int64)
    return alpha_s, beta_s


def lcc_encode(X, N: int, K: int, T: int, p: int = DEFAULT_PRIME,
               rng: np.random.RandomState = None) -> np.ndarray:
    """LCC shares: split ``X [m, d]`` into K chunks + T random chunks,
    Lagrange-interpolate through beta points, evaluate at N alpha points
    (reference LCC_encoding :111-134). Returns [N, m//K, d]."""
    rng = rng or np.random.RandomState()
    X = np.mod(np.asarray(X, np.int64), p)
    m, d = X.shape
    assert m % K == 0, "rows must divide K"
    chunks = X.reshape(K, m // K, d)
    if T > 0:
        noise = rng.randint(0, p, size=(T, m // K, d)).astype(np.int64)
        chunks = np.concatenate([chunks, noise], axis=0)
    alpha_s, beta_s = _lcc_points(N, K, T, p)
    U = lagrange_coeffs(alpha_s, beta_s, p)  # [N, K+T]
    out = _mod_matmul(U, chunks.reshape(K + T, -1), p)
    return out.reshape(N, m // K, d)


def lcc_decode(f_eval: np.ndarray, worker_idx, N: int, K: int, T: int,
               p: int = DEFAULT_PRIME) -> np.ndarray:
    """Recover the K data chunks from ≥K+T share evaluations
    (reference LCC_decoding :195-211). Returns [K, rows, d]."""
    alpha_s, beta_s = _lcc_points(N, K, T, p)
    worker_idx = np.asarray(worker_idx)
    if len(worker_idx) < K + T:
        raise ValueError(
            f"lcc_decode needs >= K+T = {K + T} shares, got {len(worker_idx)}"
        )
    U = lagrange_coeffs(beta_s[:K], alpha_s[worker_idx], p)  # [K, W]
    flat = f_eval.reshape(len(worker_idx), -1)
    rec = _mod_matmul(U, flat, p)
    return rec.reshape((K,) + f_eval.shape[1:])


def lcc_encode_with_points(X, alpha_s, beta_s, p: int = DEFAULT_PRIME):
    """Evaluate the interpolant of (beta_i → X_i) at alpha points
    (reference LCC_encoding_with_points :227-246)."""
    X = np.mod(np.asarray(X, np.int64), p)
    U = lagrange_coeffs(alpha_s, beta_s, p)
    flat = X.reshape(len(beta_s), -1)
    return _mod_matmul(U, flat, p).reshape((len(alpha_s),) + X.shape[1:])


def lcc_decode_with_points(f_eval, eval_points, target_points,
                           p: int = DEFAULT_PRIME):
    """Inverse of the above (reference LCC_decoding_with_points :249-260)."""
    return lcc_encode_with_points(f_eval, target_points, eval_points, p)


# ---------------------------------------------------------------------------
# Additive secret sharing + key agreement
# ---------------------------------------------------------------------------

def additive_shares(x, n_out: int, p: int = DEFAULT_PRIME,
                    rng: np.random.RandomState = None) -> np.ndarray:
    """n_out shares summing to x mod p (reference Gen_Additive_SS :214-224)."""
    rng = rng or np.random.RandomState()
    x = np.mod(np.asarray(x, np.int64), p)
    shares = rng.randint(0, p, size=(n_out,) + x.shape).astype(np.int64)
    shares[-1] = np.mod(x - np.mod(shares[:-1].sum(axis=0), p), p)
    return shares


def pk_gen(sk: int, p: int = DEFAULT_PRIME, g: int = 3) -> int:
    """g^sk mod p (reference my_pk_gen :263-268)."""
    return pow(g, int(sk), p)


def key_agreement(my_sk: int, other_pk: int, p: int = DEFAULT_PRIME) -> int:
    """Diffie-Hellman shared key pk^sk mod p (reference my_key_agreement
    :271-276) — symmetric in the two parties."""
    return pow(int(other_pk), int(my_sk), p)


# ---------------------------------------------------------------------------
# Fixed-point quantization (model weights ↔ field elements)
# ---------------------------------------------------------------------------

def quantize(x: np.ndarray, scale: int = 2 ** 16,
             p: int = DEFAULT_PRIME) -> np.ndarray:
    """Real → field: round(x·scale) mod p, negatives wrap to [p/2, p)."""
    return np.mod(np.round(np.asarray(x, np.float64) * scale).astype(np.int64), p)


def dequantize(q: np.ndarray, scale: int = 2 ** 16,
               p: int = DEFAULT_PRIME) -> np.ndarray:
    """Field → real, mapping [p/2, p) back to negatives."""
    q = np.asarray(q, np.int64)
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / scale
