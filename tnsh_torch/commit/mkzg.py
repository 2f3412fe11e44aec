"""PST-style multilinear KZG polynomial commitment.

Counterpart of ``tnsh/commit/mkzg.py``.  The verifier-enforced (sound)
protocols need a commitment scheme whose openings ARE multilinear
evaluations; this module provides the standard Papamanthou-Shi-Tamassia
(PST13) multilinear KZG over BN254:

  setup   : taus = (tau_0..tau_{n-1}) drawn from the deterministic ChaCha20
            stream (same transparency stance as the reference, which keeps
            tau in ProverParams — utils.rs:62); SRS = the multilinear
            Lagrange basis at tau, [eq(b, tau)]_1 for b in {0,1}^m over
            every suffix (tau_i..tau_{n-1}), plus [tau_i]_2.
  commit  : C = sum_b v_b [eq(b, tau)]_1 = [~v(tau)]_1 — one MSM over the
            raw evaluation table (tnsh_torch.commit.kzg.msm, on the
            device the caller names).
  open(r) : v = ~v(r) plus n quotient commitments Q_i with
            ~v(X) - v = sum_i (X_i - r_i) q_i(X_{i+1..}); q_i is the
            fold-difference table, so the whole opening is O(2^n) field ops
            + n shrinking MSMs.
  verify  : e(C - [v]_1, [1]_2) == prod_i e(Q_i, [tau_i]_2 - [r_i]_2),
            checked as a single pairing product (native multi-Miller loop).

Variable order matches the sum-check engine: variable 0 is the FASTEST
index bit (little-endian, reference polynomials.rs:108-122), and opening
folds variable 0 first — so a sum-check challenge vector is directly a
valid opening point.

``commit``, ``commit_many`` and ``open`` take the device their MSMs run on
as a required argument and hand it to ``tnsh_torch.commit.kzg``'s router;
``prepare_device`` uploads the SRS segments that router will use.

The tables of a batch of gamma-RLC openings can also be computed on the
device from the committed columns: ``ColumnStack`` uploads the columns
once and gives their values at a point (a chain of ``fr_kernels.fold``)
and their RLC table (``fr_kernels.rlc``); ``MultilinearKZG.open_device``
opens such tables (``fr_kernels.open_level``, a launch a level) and sends
the quotient words to the same MSMs as ``open``: the levels the router
sends to the device stay there, the rest come back as bytes.  Values,
quotient words and proofs equal the host engine's byte for byte.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native
from ..core.params import SETUP_SEED, NativeSRS
from ..core.rng import ChaCha20Rng, fr_rand
from ..errors import CommitmentError
from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..field.g1 import G1
from ..field.g2 import G2
from ..utils.profiling import count, span
from . import kzg
from .kzg import (
    KZGCommitmentValue,
    device_srs_context,
    msm,
    srs_msm_async,
)

_P = MODULUS


@dataclass
class MLCommitmentParams:
    """Prover-side SRS for up to ``num_vars`` variables.

    ``basis[i]`` is the Lagrange basis at ``(tau_i..tau_{n-1})`` — a list of
    ``2^(n-i)`` G1 points; ``basis[0]`` commits full-width polynomials and
    ``basis[i+1]`` commits the i-th opening quotient.
    """

    num_vars: int
    basis: List[List[G1]]
    taus: Optional[List[Fr]]


@dataclass
class MLVerificationKey:
    g1_generator: G1
    g2_generator: G2
    g2_taus: List[G2]


@dataclass
class MLOpeningProof:
    """value + per-variable quotient commitments."""

    quotients: List[G1]

    def serialize_compressed(self) -> bytes:
        from ..core.serialize import g1_to_bytes

        out = [len(self.quotients).to_bytes(8, "little")]
        out += [g1_to_bytes(q) for q in self.quotients]
        return b"".join(out)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "MLOpeningProof":
        from ..core.serialize import g1_from_bytes

        n = int.from_bytes(data[:8], "little")
        qs = []
        off = 8
        for _ in range(n):
            qs.append(g1_from_bytes(data[off : off + 32]))
            off += 32
        return cls(qs)


def _basis_scalars(taus: Sequence[Fr]) -> List[int]:
    """eq(b, taus) for all b, little-endian (variable 0 = bit 0, fastest)."""
    table = [1]
    for t in taus:  # variable m joins as the SLOWEST bit so far -> bit m
        ti = int(t)
        nt = (1 - ti) % _P
        table = [v * nt % _P for v in table] + [v * ti % _P for v in table]
    return table


#: Externally supplied SRS registry: num_vars -> (params, vk).  When set,
#: ``setup_multilinear_params`` returns the installed SRS instead of the
#: deterministic one, so sound-mode proofs can run against a ceremony SRS
#: whose trapdoor nobody holds.
_EXTERNAL_SRS: dict = {}


def install_external_multilinear_srs(
    params: MLCommitmentParams, vk: MLVerificationKey
) -> None:
    """Route ``setup_multilinear_params(params.num_vars)`` to an externally
    supplied SRS (e.g. from :func:`generate_multilinear_srs` run in a
    ceremony, with the taus discarded)."""
    _EXTERNAL_SRS[params.num_vars] = (params, vk)


def clear_external_multilinear_srs(num_vars: Optional[int] = None) -> None:
    if num_vars is None:
        _EXTERNAL_SRS.clear()
    else:
        _EXTERNAL_SRS.pop(num_vars, None)


def has_external_multilinear_srs(num_vars: int) -> bool:
    """True when ``setup_multilinear_params(num_vars)`` serves a ceremony
    SRS whose trapdoor is unknown — factorized (tau-aware) cube paths must
    not be used then."""
    return num_vars in _EXTERNAL_SRS


def generate_multilinear_srs(
    num_vars: int,
    taus: Sequence[Fr],
    keep_taus: bool = False,
) -> Tuple[MLCommitmentParams, MLVerificationKey]:
    """Build a PST SRS from explicit trapdoor scalars.

    With ``keep_taus=False`` (the honest-ceremony mode) the returned params
    do NOT retain the taus: after the caller discards its copy, no one can
    forge openings.
    """
    taus = [Fr(t) for t in taus]
    if len(taus) != num_vars:
        raise CommitmentError("need exactly num_vars trapdoor scalars")
    g1_gen = G1.generator()
    g2_gen = G2.generator()

    basis: List = []
    if _native.available:
        # Each basis segment stays native-resident (NativeSRS handle):
        # commits/quotient MSMs run against the handle with zero point
        # marshalling, and setup never materializes Python G1 objects.
        for i in range(num_vars + 1):
            seg_bytes = b"".join(
                s.to_bytes(32, "little") for s in _basis_scalars(taus[i:])
            )
            basis.append(
                NativeSRS(_native.srs_create_fixed_base(g1_gen, seg_bytes))
            )
        g2_taus = [_native.g2_scalar_mul(g2_gen, t) for t in taus]
    else:
        from ..core.params import _fixed_base_powers

        all_scalars: List[Fr] = []
        seg_sizes: List[int] = []
        for i in range(num_vars + 1):
            seg = _basis_scalars(taus[i:])
            seg_sizes.append(len(seg))
            all_scalars.extend(Fr(s) for s in seg)
        pts = _fixed_base_powers(g1_gen, all_scalars)
        off = 0
        for size in seg_sizes:
            basis.append(pts[off : off + size])
            off += size
        g2_taus = [g2_gen.scalar_mul(int(t)) for t in taus]

    params = MLCommitmentParams(
        num_vars=num_vars, basis=basis, taus=taus if keep_taus else None
    )
    vk = MLVerificationKey(
        g1_generator=g1_gen, g2_generator=g2_gen, g2_taus=g2_taus
    )
    return params, vk


@_native.cached_per_mode(32)
def _deterministic_multilinear_params(
    num_vars: int, native: bool,
) -> Tuple[MLCommitmentParams, MLVerificationKey]:
    """The deterministic PST SRS, cached per size and engine mode."""
    rng = ChaCha20Rng.from_seed(SETUP_SEED)
    taus = [fr_rand(rng) for _ in range(num_vars)]
    return generate_multilinear_srs(num_vars, taus, keep_taus=True)


@_native.cached_per_mode(64)
def _deterministic_vk(num_vars: int, native: bool) -> MLVerificationKey:
    rng = ChaCha20Rng.from_seed(SETUP_SEED)
    taus = [fr_rand(rng) for _ in range(num_vars)]
    g2_gen = G2.generator()
    if native:
        g2_taus = [_native.g2_scalar_mul(g2_gen, t) for t in taus]
    else:
        g2_taus = [g2_gen.scalar_mul(int(t)) for t in taus]
    return MLVerificationKey(
        g1_generator=G1.generator(), g2_generator=g2_gen, g2_taus=g2_taus
    )


def multilinear_verification_key(num_vars: int) -> MLVerificationKey:
    """The PST verification key alone — O(num_vars) group work, never
    materializing the 2^num_vars prover SRS.  Sound-mode VERIFIERS use
    this so verifying a big-cube proof stays logarithmic."""
    ext = _EXTERNAL_SRS.get(num_vars)
    if ext is not None:
        return ext[1]
    return _deterministic_vk(num_vars)


def setup_multilinear_params(
    num_vars: int,
) -> Tuple[MLCommitmentParams, MLVerificationKey]:
    """PST setup for ``num_vars`` variables.

    Default: DETERMINISTIC taus from the fixed ``[42u8; 32]`` stream.
    **This is reproducibility plumbing, not a
    trusted setup**: anyone can rederive the taus and forge openings,
    so sound-mode proofs under the
    default SRS bind only against adversaries who do not exploit the public
    trapdoor.  For real deployments, generate an SRS in a ceremony with
    :func:`generate_multilinear_srs(keep_taus=False)` and register it with
    :func:`install_external_multilinear_srs`; this function then serves the
    external SRS instead.
    """
    ext = _EXTERNAL_SRS.get(num_vars)
    if ext is not None:
        return ext
    return _deterministic_multilinear_params(num_vars)


class MultilinearKZG:
    """Commit / open / verify for dense multilinear evaluation tables."""

    @staticmethod
    def prepare_device(params: MLCommitmentParams, device) -> None:
        """Upload every SRS segment that an MSM on ``device`` will use
        (those of ``DEVICE_MSM_MIN`` points or more), once: set-up work,
        kept out of the first commitment's time."""
        for seg in params.basis:
            if isinstance(seg, NativeSRS) and len(seg) >= kzg.DEVICE_MSM_MIN:
                device_srs_context(seg.srs_id, device)

    @staticmethod
    def commit(
        params: MLCommitmentParams, evaluations: Sequence[Fr], device,
    ) -> KZGCommitmentValue:
        n_vars = _infer_vars(len(evaluations))
        if n_vars > params.num_vars:
            raise CommitmentError("polynomial exceeds SRS size")
        seg = params.basis[params.num_vars - n_vars]
        if not isinstance(seg, NativeSRS):
            evaluations = list(evaluations)
        return KZGCommitmentValue(msm(seg, evaluations, device))

    @staticmethod
    def commit_many(
        params: MLCommitmentParams, tables: Sequence[Sequence[Fr]], device,
    ) -> List[KZGCommitmentValue]:
        """Commit a batch of equal-length columns in ONE burst: over a
        native-resident SRS segment every column's MSM is dispatched
        before any is waited for.  Identical commitments to per-column
        :meth:`commit` on any route."""
        return [fin() for fin in
                MultilinearKZG.commit_many_async(params, tables, device)]

    @staticmethod
    def commit_many_async(
        params: MLCommitmentParams, tables: Sequence[Sequence[Fr]], device,
    ) -> List[Callable[[], KZGCommitmentValue]]:
        """:meth:`commit_many`'s dispatch: the finishers of the columns'
        MSMs, so that a caller can dispatch other MSMs before it waits."""
        tables = list(tables)
        if not tables:
            return []
        size = len(tables[0])
        n_vars = _infer_vars(size)
        if n_vars > params.num_vars:
            raise CommitmentError("polynomial exceeds SRS size")
        if any(len(t) != size for t in tables):
            raise CommitmentError("commit_many needs equal-length tables")
        seg = params.basis[params.num_vars - n_vars]
        if (isinstance(seg, NativeSRS) and size >= kzg.DEVICE_MSM_MIN
                and _native.available):
            fins = [srs_msm_async(seg.srs_id, limbs.le_bytes(t), device)
                    for t in tables]
            return [lambda fin=fin: KZGCommitmentValue(fin()) for fin in fins]
        return [lambda t=t: MultilinearKZG.commit(params, t, device)
                for t in tables]

    @staticmethod
    def open(
        params: MLCommitmentParams,
        evaluations: Sequence[Fr],
        point: Sequence[Fr],
        device,
    ) -> Tuple[Fr, MLOpeningProof]:
        n_vars = _infer_vars(len(evaluations))
        if len(point) != n_vars:
            raise CommitmentError("opening point has wrong arity")
        offset = params.num_vars - n_vars
        if n_vars > 0 and _native.available:
            # Quotient tables computed natively; bytes feed the MSMs
            # without per-element Fr round-trips.
            with span("quotients"):
                value, levels = _native.fr_ml_open(evaluations, point)
            return value, _level_msms(params, levels, device)
        table = [int(v) % _P for v in evaluations]
        quotients: List[G1] = []
        for i in range(n_vars):
            half = len(table) // 2
            diff = [(table[2 * j + 1] - table[2 * j]) % _P for j in range(half)]
            quotients.append(msm(params.basis[offset + i + 1],
                                 [Fr(d) for d in diff], device))
            r = int(point[i])
            table = [
                (table[2 * j] + r * diff[j]) % _P for j in range(half)
            ]
        return Fr(table[0]), MLOpeningProof(quotients)

    @staticmethod
    def open_device(
        params: MLCommitmentParams,
        tables: List[torch.Tensor],
        points: Sequence[Sequence[Fr]],
        device,
    ) -> List[Tuple[Fr, MLOpeningProof]]:
        """:meth:`open` of ``(8, N)`` Montgomery tables that live on a
        device (``ColumnStack.rlc``), table i at ``points[i]``.  Each
        table's quotient words are computed there, a launch a level; the
        levels of device MSMs stay there and the others come back in one
        copy (``_device_quotients``); ``tables`` is emptied as they do, so
        no table is alive when the first level MSM is queued (its caller
        holds no other reference).  The MSMs then run as ``open``'s, on
        ``device``'s router.  Same values and proofs as ``open`` over the
        tables' values."""
        quotients = []
        while tables:
            table = tables.pop(0)
            quotients.append(_device_quotients(table,
                                               points[len(quotients)]))
            del table
        return [(value, _level_msms(params, levels, device))
                for value, levels in quotients]

    @staticmethod
    def verify(
        vk: MLVerificationKey,
        commitment: KZGCommitmentValue,
        point: Sequence[Fr],
        value: Fr,
        proof: MLOpeningProof,
        num_total_vars: Optional[int] = None,
    ) -> bool:
        n_vars = len(point)
        if len(proof.quotients) != n_vars:
            return False
        total = num_total_vars if num_total_vars is not None else n_vars
        offset = total - n_vars
        left = commitment.commitment - vk.g1_generator.scalar_mul(int(value))
        pairs = [(left.neg(), vk.g2_generator)]
        for i in range(n_vars):
            g2_term = vk.g2_taus[offset + i] - vk.g2_generator.scalar_mul(
                int(point[i])
            )
            pairs.append((proof.quotients[i], g2_term))
        if _native.available:
            return _native.pairing_product_is_one(pairs)
        from ..field.pairing import pairing_product_is_one

        return pairing_product_is_one(pairs)


def _infer_vars(length: int) -> int:
    if length <= 0 or length & (length - 1):
        raise CommitmentError("evaluation table must be a power of two")
    return length.bit_length() - 1


def _level_msms(params: MLCommitmentParams, levels: Sequence,
                device) -> MLOpeningProof:
    """The quotient commitments of an opening from each level's quotient
    words (level i: 2^(n-1-i) words, as bytes or as an ``(N, 8)`` int32
    tensor on the device): every level's MSM is dispatched before any is
    waited for."""
    offset = params.num_vars - len(levels)
    fins = []
    for i, words in enumerate(levels):
        seg = params.basis[offset + i + 1]
        if isinstance(seg, NativeSRS):
            fins.append(srs_msm_async(seg.srs_id, words, device))
        else:
            fins.append(lambda s=seg, lv=words: msm(s, lv, device))
    return MLOpeningProof([fin() for fin in fins])


def _device_quotients(table: torch.Tensor, point: Sequence[Fr]
                      ) -> Tuple[Fr, list]:
    """(value, each level's quotient words) of the opening of an ``(8, N)``
    Montgomery table at ``point``, the words as ``_native.fr_ml_open``
    gives them: the levels are written into one ``(N - 1, 8)`` buffer on
    the table's device at ``fr_ml_open``'s offsets.  A level of
    ``kzg.DEVICE_MSM_MIN`` words or more, whose MSM the router sends to
    the device, stays there as a slice of the buffer; the smaller ones,
    for the host MSM, come back as bytes in one copy.  Timed as the span
    ``quotients``."""
    n = table.shape[1]
    if len(point) != _infer_vars(n):
        raise CommitmentError("opening point has wrong arity")
    with span("quotients"):
        quot = torch.empty((n - 1, limbs.NUM_LIMBS), dtype=torch.int32,
                           device=table.device)
        bounds = []
        for i, r in enumerate(point):
            off = n - (n >> i)
            half = n >> (i + 1)
            table = fr_kernels.open_level(table, r, quot[off:off + half])
            bounds.append((off, off + half))
        value = Fr(limbs.unpack(table)[0])
        # the levels shrink, so the host's are the buffer's tail
        first = next((a for a, b in bounds if b - a < kzg.DEVICE_MSM_MIN),
                     n - 1)
        words = quot[first:].cpu().numpy()
        return value, [quot[a:b] if a < first
                       else words[a - first:b - first].tobytes()
                       for a, b in bounds]


def _column_words(raw: bytes, n: int) -> torch.Tensor:
    """An ``FrTable``'s 32-byte words as an ``(N, 8)`` int32 tensor over
    its bytes, without a copy.  Bytes are read-only and torch warns so;
    nothing writes this tensor."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(raw, dtype=torch.int32).view(
            n, limbs.NUM_LIMBS)


class ColumnStack:
    """Committed columns as one ``(F, 8, N)`` Montgomery stack on a device,
    for the tables of a batch of gamma-RLC PST openings: the values of a
    group of columns at a point (``evals``) and their RLC table (``rlc``),
    computed there.

    ``columns`` are ``FrTable``s of one length: each goes up as its raw
    words, one host-to-device copy a column, and the transpose to limb
    planes and the Montgomery conversion run on ``device``.  A group of
    all the columns in order is the stack itself; any other group is
    gathered from it.  The stack is counted once as ``open_device_columns``
    (its F)."""

    def __init__(self, columns: Sequence, device):
        n = len(columns[0])
        self.stack = torch.empty((len(columns), limbs.NUM_LIMBS, n),
                                 dtype=torch.int32, device=device)
        for i, column in enumerate(columns):
            words = _column_words(column.raw, n).to(device)
            self.stack[i] = fr_kernels.to_mont(words.t().contiguous())
        count("open_device_columns", len(columns))

    def _rows(self, cols: Sequence[int]) -> torch.Tensor:
        """The stack's rows of ``cols``, in that order."""
        cols = list(cols)
        if cols == list(range(self.stack.shape[0])):
            return self.stack
        return self.stack[cols]

    def evals(self, cols: Sequence[int], point: Sequence[Fr]) -> List[Fr]:
        """[~column(point) for each of ``cols``], as
        ``_native.fr_mle_eval_many`` gives them: log N folds of their rows
        (variable 0 first), then one copy of F words back."""
        tabs = self._rows(cols)
        if len(point) != _infer_vars(tabs.shape[2]):
            raise CommitmentError("evaluation point has wrong arity")
        for r in point:
            tabs = fr_kernels.fold(tabs, r)
        return [Fr(v) for v in limbs.unpack(tabs[:, :, 0].t().contiguous())]

    def rlc(self, cols: Sequence[int], gamma: int) -> torch.Tensor:
        """Σ_i gamma^i · cols[i] as an ``(8, N)`` Montgomery table on the
        device (``_native.fr_rlc``'s values), one launch."""
        tabs = self._rows(cols)
        words = np.zeros((tabs.shape[0], limbs.NUM_LIMBS), dtype=np.uint32)
        w = 1
        for i in range(tabs.shape[0]):
            words[i] = limbs.mont_words(w)
            w = w * int(gamma) % _P
        coeffs = torch.from_numpy(words.view(np.int32)).to(tabs.device)
        return fr_kernels.rlc(tabs, coeffs)


def batch_verify_openings(items) -> bool:
    """Verify many PST openings with ONE pairing product.

    ``items``: sequence of ``(vk, commitment, point, value, proof)``.
    Standard RLC batching: random weights gamma_i are derived from a
    transcript over the full statement, the commitment-side pairs collapse
    into a single e(-sum gamma_i (C_i - v_i G), [1]_2), and openings AT THE
    SAME POINT (under the same vk) share their G2 terms, so their quotients
    merge into one weighted G1 point per variable.  For sound-Twist's 16
    openings this is ~174 Miller loops + 1 final exponentiation instead of
    ~242 + 16.  Soundness error ~items/r.
    """
    items = list(items)
    if not items:
        return True
    from ..core.transcript import Transcript

    t = Transcript(bytes(32))
    for vk, comm, point, value, proof in items:
        t.append_field_element(b"mlbatch_commitment", comm.hash())
        t.append_field_elements(b"mlbatch_point", list(point))
        t.append_field_element(b"mlbatch_value", value)
        for q in proof.quotients:
            t.append_field_element(
                b"mlbatch_quotient", KZGCommitmentValue(q).hash()
            )
    gamma = t.challenge_field_element(b"mlbatch_gamma")

    g2_gen = items[0][0].g2_generator
    g1_gen = items[0][0].g1_generator

    def smul(p: G1, s: int) -> G1:
        if s == 1:
            return p
        if _native.available:
            return _native.g1_scalar_mul(p, Fr(s))
        return p.scalar_mul(s)

    acc_c = G1.zero()
    acc_v = 0
    groups = {}  # (id(vk), point tuple) -> [vk, point, [weighted Q sums]]
    weight = Fr(1)
    for vk, comm, point, value, proof in items:
        if len(proof.quotients) != len(point):
            return False
        w = int(weight)
        acc_c = acc_c.add(smul(comm.commitment, w))
        acc_v = (acc_v + w * int(value)) % _P
        key = (id(vk), tuple(int(x) for x in point))
        g = groups.get(key)
        if g is None:
            g = [vk, list(point), [G1.zero()] * len(point)]
            groups[key] = g
        for m, q in enumerate(proof.quotients):
            g[2][m] = g[2][m].add(smul(q, w))
        weight = weight * gamma

    # e(Q, [tau_m] - r_m [1]_2) would need a G2 scalar-mul per variable
    # per group (the dominant verify cost at ~2n+k pairs); instead fold
    # the -r_m side into G1 — e(Q, [tau_m]) * e(-r_m Q, [1]_2) — so the
    # [1]_2 terms all merge into ONE pair and pairs sharing the same
    # [tau_m]_2 point (same vk level, any opening point) merge too.
    gen_acc = acc_c.neg().add(smul(g1_gen, acc_v))  # = -(acc_c - [v]G)
    tau_acc = {}  # id(g2_tau point) -> [g2_point, G1 accumulator]
    for vk, point, qsums in groups.values():
        for m, q in enumerate(qsums):
            t2 = vk.g2_taus[m]
            key = id(t2)
            slot = tau_acc.get(key)
            if slot is None:
                slot = [t2, G1.zero()]
                tau_acc[key] = slot
            slot[1] = slot[1].add(q)
            gen_acc = gen_acc.add(smul(q, (-int(point[m])) % _P))
    pairs = [(gen_acc, g2_gen)]
    pairs += [(acc, t2) for t2, acc in tau_acc.values()]
    if _native.available:
        return _native.pairing_product_is_one(pairs)
    from ..field.pairing import pairing_product_is_one

    return pairing_product_is_one(pairs)
