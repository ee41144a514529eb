"""Product-matrix MSR regenerating code over GF(2^8) (the port of
``chunky_bits_tpu/ops/pm_msr.py``).

The construction is Rashmi-Shah-Kumar's product-matrix MSR code at the
``d = 2(k-1)`` point, in the systematic form the "Fast Product-Matrix
Regenerating Codes" line (PAPERS.md, arXiv:1412.3022) benchmarks, with
the polynomial-realization framing of arXiv:1312.5155 guiding the
implementation shape: every operation — encode, decode, helper
projection, repair combine — is a GF(2^8) matrix applied to stacked
sub-symbol stripes, so the whole code runs through the exact
``ErasureBackend.apply_matrix`` primitive the Reed-Solomon path uses
(the GF(2^8) kernel on the card, its plain version or numpy tables on
the host) and is byte-identical across numpy/torch/cuda by the same
argument: on ``cuda`` it is K1 at the sub-stripe shapes, with no kernel
of its own.

**Shape.**  A part still has ``k`` data + ``p`` parity chunks behind
the same ``Chunk`` wire format; each chunk is additionally α = k-1
contiguous sub-symbol stripes (chunk bytes [j*S/α, (j+1)*S/α) form
stripe j — a plain C-order reshape).  Byte position t of every stripe
is one independent MSR codeword over GF(2^8):

    message matrix  M = [S1; S2]   (2α x α, S1/S2 symmetric — B = kα
                                    free symbols)
    encoding matrix Ψ = [Φ  ΛΦ]    (n x 2α Vandermonde on distinct
                                    x_i = g^i; Φ its first α columns,
                                    λ_i = x_i^α distinct)
    node i stores   ψ_i^T M        (α symbols)

Any 2α rows of Ψ are independent (Vandermonde), any α rows of Φ are
independent, and the λ_i are distinct — the three RSK conditions, so
any ``k`` nodes reconstruct and any single node regenerates exactly
from any ``d' = 2(k-1)`` helpers, each contributing ONE symbol
(β = chunk/α bytes): helper i ships ``ψ_i^T M φ_f``, the collector
inverts the helpers' Ψ rows to get ``M φ_f = [S1 φ_f; S2 φ_f]`` and
reads the lost row back off the symmetry of S1/S2.  Total repair
traffic ``d'·β = 2·chunk`` instead of Reed-Solomon's ``k·chunk``.

**Systematic remap.**  The raw construction is not systematic; because
the data-collection property makes ``message -> first-k-node contents``
a bijection, the code precomputes the linear map ``T`` (message to all
node contents), inverts its systematic block, and keeps the composite
generator ``G = T · T_sys^{-1}`` whose top ``kα`` rows are the
identity — data chunks store the user's bytes verbatim (old readers
and the interop decoder keep working), parity chunks are ``G``'s
bottom ``pα`` rows applied per stripe.  Node contents remain of the
form ``Ψ [S1; S2]`` for symmetric S1/S2 (the remap only re-chooses the
message), so the repair identities above hold unchanged.

**Geometry.**  ``k >= 2``, ``p >= k-1`` (so ``d' = 2(k-1) <= n-1``
helpers exist), ``n <= 255`` (distinct nonzero x_i), the λ_i must be
distinct (checked; fails only for α sharing a large factor with 255 at
very wide n), and chunk sizes must be α-divisible (the writer rounds
shard lengths up; power-of-two chunk sizes additionally need α to be a
power of two).  ``geometry_error`` is the one shared validator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256, matrix
from chunky_bits_tpu_torch.ops.backend import ErasureBackend, ErasureCoder

#: the wire-format name (file/chunk.py ``code:`` field, cluster profile
#: ``code`` knob) — THE closed-set value next to "rs"
CODE_NAME = "pm-msr"


def geometry_error(data: int, parity: int,
                   chunk_size: Optional[int] = None) -> Optional[str]:
    """Why (data, parity[, chunk_size]) cannot run pm-msr, or None.

    The one validator shared by profile parsing (loud SerdeError for an
    explicit YAML ``code: pm-msr``), the env-default leniency check
    (an env-requested default silently stays ``rs`` on unsupported
    geometry), and the coder constructor."""
    if data < 2:
        return "pm-msr needs data >= 2 (alpha = data-1 sub-symbols)"
    if parity < data - 1:
        return (f"pm-msr needs parity >= data-1 "
                f"({2 * (data - 1)} helpers must survive one loss); "
                f"got d={data} p={parity}")
    n = data + parity
    if n > 255:
        return f"pm-msr needs d+p <= 255 distinct GF(2^8) points, got {n}"
    alpha = data - 1
    lams = {gf256.gf_pow(gf256.gf_pow(gf256.GF_GEN, i), alpha)
            for i in range(n)}
    if len(lams) != n:
        return (f"pm-msr x_i^alpha collision at d={data} p={parity} "
                f"(alpha={alpha} shares a factor with 255 at this width)")
    if chunk_size is not None and chunk_size % alpha != 0:
        return (f"pm-msr needs chunk_size divisible by alpha={alpha}, "
                f"got {chunk_size}")
    return None


def _build_generator(data: int, parity: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """(G [nα, kα], Φ [n, α], λ [n], Ψ [n, 2α]) for one geometry.

    ``G``'s top kα rows are asserted to be the identity (systematic);
    construction cost is O((nα)·(kα)) small-int GF ops — matrices are
    tiny (kα <= ~60 for realistic widths) and cached per geometry by
    ``get_coder``.
    """
    err = geometry_error(data, parity)
    if err is not None:
        raise ErasureError(err)
    alpha = data - 1
    dh = 2 * alpha
    n = data + parity
    xs = [gf256.gf_pow(gf256.GF_GEN, i) for i in range(n)]
    psi = np.zeros((n, dh), dtype=np.uint8)
    for i, x in enumerate(xs):
        for j in range(dh):
            psi[i, j] = gf256.gf_pow(x, j)
    phi = psi[:, :alpha].copy()
    lam = np.array([gf256.gf_pow(x, alpha) for x in xs], dtype=np.uint8)

    # message layout: S1's upper triangle then S2's — B = α(α+1) = kα
    tri = [(i, j) for i in range(alpha) for j in range(i, alpha)]
    b_syms = 2 * len(tri)
    assert b_syms == data * alpha

    t_mat = np.zeros((n * alpha, b_syms), dtype=np.uint8)
    for t in range(b_syms):
        s1 = np.zeros((alpha, alpha), dtype=np.uint8)
        s2 = np.zeros((alpha, alpha), dtype=np.uint8)
        if t < len(tri):
            i, j = tri[t]
            s1[i, j] = s1[j, i] = 1
        else:
            i, j = tri[t - len(tri)]
            s2[i, j] = s2[j, i] = 1
        m = np.concatenate([s1, s2], axis=0)  # [2α, α]
        t_mat[:, t] = matrix.gf_matmul(psi, m).reshape(-1)
    # data-collection property => the systematic block is invertible
    gen = matrix.gf_matmul(t_mat, matrix.gf_invert(t_mat[:data * alpha]))
    assert np.array_equal(gen[:data * alpha],
                          np.eye(data * alpha, dtype=np.uint8))
    return gen, phi, lam, psi


class PMMSRCoder(ErasureCoder):
    """The product-matrix MSR codec for one (k, p) geometry, presenting
    the same surface as the Reed-Solomon ``ErasureCoder`` (encode /
    reconstruct / batched variants) plus the regeneration surface the
    repair planner drives (``projection_matrix`` / ``repair_matrix`` /
    ``project_batch`` / ``repair_batch``).

    All shard/stripe math dispatches through ``backend.apply_matrix``,
    so the backend-identity tests cover this code with no new kernels.
    """

    code = CODE_NAME
    #: a backend's fused encode+hash applies the RS [p, d] parity map at
    #: chunk granularity; pm-msr's parity map is [pα, kα] over
    #: sub-stripes, so it takes the decomposed path
    supports_fused_ingest = False

    def __init__(self, data: int, parity: int,
                 backend: Optional[ErasureBackend] = None) -> None:
        # deliberately NOT calling super().__init__: the RS Vandermonde
        # encode matrix does not exist for this code, and leaving a
        # wrong-shaped ``parity_rows`` around would invite misuse
        from chunky_bits_tpu_torch.ops.backend import get_backend

        self.data = data
        self.parity = parity
        self.backend = backend or get_backend()
        self.gen_matrix, self.phi, self.lam, self.psi = \
            _build_generator(data, parity)
        self.alpha = data - 1
        #: helpers a single-chunk regeneration needs (d' = 2(k-1))
        self.helpers = 2 * self.alpha

    # ---- geometry helpers ----

    def shard_len(self, length: int) -> int:
        """ceil(length/k) rounded up to an α multiple — every chunk
        must split into α equal stripes."""
        base = (length + self.data - 1) // self.data if length > 0 else 0
        return ((base + self.alpha - 1) // self.alpha) * self.alpha

    def beta_bytes(self, chunksize: int) -> int:
        """One helper's repair contribution for a ``chunksize`` chunk."""
        self._check_size(chunksize)
        return chunksize // self.alpha

    def _check_size(self, size: int) -> None:
        if size % self.alpha != 0:
            raise ErasureError(
                f"pm-msr shard length must be a multiple of "
                f"alpha={self.alpha}, got {size}")

    def _sub(self, shards: np.ndarray) -> np.ndarray:
        """[B, rows, S] -> [B, rows*α, S/α] (stripes are contiguous
        chunk segments, so this is a plain C-order reshape)."""
        b, rows, s = shards.shape
        self._check_size(s)
        return np.ascontiguousarray(shards).reshape(
            b, rows * self.alpha, s // self.alpha)

    # ---- batched codec surface (same contract as ErasureCoder) ----

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """parity[B, p, S] from data[B, k, S] (S % α == 0)."""
        if data.ndim != 3 or data.shape[1] != self.data:
            raise ErasureError(
                f"expected data shaped [B, {self.data}, S], "
                f"got {data.shape}")
        b, _, s = data.shape
        if s == 0:
            return np.zeros((b, self.parity, 0), dtype=np.uint8)
        out = self.backend.apply_matrix(
            self.gen_matrix[self.data * self.alpha:], self._sub(data))
        return out.reshape(b, self.parity, s)

    # encode_hash_batch is inherited: ``supports_fused_ingest = False``
    # makes the base method skip the backend's chunk-granular fused
    # pass (wrong matrix shape for a stripe-structured code) and run
    # this class's encode_batch + per-shard hashing

    def reconstruct_batch_picked(
        self, picked: np.ndarray, present: Sequence[int],
        wanted: Sequence[int],
    ) -> np.ndarray:
        """Rebuild ``wanted`` chunk rows from ``picked[B, k, S]`` (the
        rows at ``sorted(present)[:k]``, in that order) — the decode
        layout ``ReconstructBatcher`` stacks straight into."""
        present = sorted(present)[:self.data]
        a = self.alpha
        pres_rows = np.array([ci * a + j for ci in present
                              for j in range(a)], dtype=np.intp)
        want_rows = np.array([ci * a + j for ci in wanted
                              for j in range(a)], dtype=np.intp)
        # any k chunks' stripe rows of G are invertible (the MDS /
        # data-collection property); gf_invert raises on the impossible
        dec = matrix.gf_matmul(
            self.gen_matrix[want_rows],
            matrix.gf_invert(self.gen_matrix[pres_rows]))
        b, _, s = picked.shape
        out = self.backend.apply_matrix(dec, self._sub(picked))
        return out.reshape(b, len(list(wanted)), s)

    # reconstruct_batch / reconstruct / reconstruct_data / encode are
    # inherited: they funnel into reconstruct_batch_picked/encode_batch

    # ---- the regeneration surface (cluster/repair.py drives it)

    def projection_matrix(self, failed: int) -> np.ndarray:
        """[1, α] helper projection coefficients for regenerating chunk
        ``failed``: every helper applies ``φ_failed`` to its own α
        stripes and ships the β-sized result.  Identical for all
        helpers — the failed node's Φ row, not the helper's."""
        self._check_index(failed)
        return self.phi[failed][None, :].copy()

    def repair_matrix(self, failed: int,
                      helpers: Sequence[int]) -> np.ndarray:
        """[α, d'] combine matrix: stacked helper projections (in
        ``helpers`` order) in, the failed chunk's α stripes out —
        ``[I | λ_f·I] · Ψ_H^{-1}`` (module docstring)."""
        self._check_index(failed)
        helpers = list(helpers)
        if len(helpers) != self.helpers:
            raise ErasureError(
                f"pm-msr repair needs exactly {self.helpers} helpers, "
                f"got {len(helpers)}")
        if failed in helpers or len(set(helpers)) != len(helpers):
            raise ErasureError(
                f"pm-msr helpers must be distinct and exclude the "
                f"failed chunk: failed={failed} helpers={helpers}")
        for h in helpers:
            self._check_index(h)
        psi_inv = matrix.gf_invert(
            self.psi[np.array(helpers, dtype=np.intp)])
        a = self.alpha
        lam_i = np.zeros((a, self.helpers), dtype=np.uint8)
        for j in range(a):
            lam_i[j, j] = 1
            lam_i[j, a + j] = int(self.lam[failed])
        return matrix.gf_matmul(lam_i, psi_inv)

    def project_batch(self, failed: int,
                      content: np.ndarray) -> np.ndarray:
        """Helper-side compute: ``content[B, S]`` (whole helper chunks,
        S % α == 0) -> ``[B, S/α]`` projections for ``failed``."""
        if content.ndim != 2:
            raise ErasureError(
                f"expected content [B, S], got {content.shape}")
        b, s = content.shape
        sub = self._sub(content.reshape(b, 1, s))
        out = self.backend.apply_matrix(self.projection_matrix(failed),
                                        sub)
        return out.reshape(b, s // self.alpha)

    def repair_batch(self, failed: int, helpers: Sequence[int],
                     projections: np.ndarray) -> np.ndarray:
        """Collector-side combine: ``projections[B, d', β]`` (row order
        = ``helpers`` order) -> the failed chunk's bytes ``[B, d'·β/2]``
        (= α·β = chunksize)."""
        if projections.ndim != 3 or projections.shape[1] != self.helpers:
            raise ErasureError(
                f"expected projections [B, {self.helpers}, beta], "
                f"got {projections.shape}")
        b, _, beta = projections.shape
        out = self.backend.apply_matrix(
            self.repair_matrix(failed, helpers),
            np.ascontiguousarray(projections))
        return out.reshape(b, self.alpha * beta)

    def _check_index(self, ci: int) -> None:
        if not 0 <= ci < self.data + self.parity:
            raise ErasureError(
                f"chunk index {ci} out of range for "
                f"d={self.data} p={self.parity}")
