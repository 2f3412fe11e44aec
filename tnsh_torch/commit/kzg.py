"""KZG polynomial and vector commitments over BN254, and the MSM behind
every commitment.

Counterpart of ``tnsh/commit/kzg.py``:

  * ``KZGCommitmentValue`` (a G1 point with the transcript hash of its
    affine x coordinate) and ``KZGProof``;
  * the univariate scheme ``KZGCommitment`` (``commit``, ``open``, the
    evaluation-basis ``commit_evals`` / ``open_evals`` over the Lagrange SRS
    of ``lagrange_srs``, ``verify``, the reference-faithful
    ``batch_verify`` and ``batch_verify_sound``), ``verify_openings_batched``
    and the vector commitment ``KZGVectorCommitment``;
  * the host ``msm`` (native Pippenger, with the pure-Python bucket method
    as the golden path) and the router that sends an MSM to the device.

The router takes the place of the JAX package's hybrid host and device
split.  There the device joined in only behind environment switches, a
warm-up gate and measured rates; here the caller names the device, and
every function that computes an MSM takes it as a required argument:

  * an MSM of ``DEVICE_MSM_MIN`` points or more runs on ``device`` through
    ``tnsh_torch.commit.msm_sched.ScheduledMsmContext`` (for a native SRS
    one context per handle and device, built once and kept);
  * a smaller one runs on the host: the native Pippenger, or under
    ``TNSH_NO_NATIVE`` the pure-Python bucket method.

Both routes produce the identical group element.  ``route_counts`` says
how many MSMs went each way.  ``host_msm`` is the host MSM over explicit
points by name: the reference the device route is held against.
Verification is host work on the native pairing, as in the JAX package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..core.params import (
    CommitmentParams,
    CommitmentVerificationKey,
    NativeSRS,
)
from ..core.rng import ChaCha20Rng, fr_rand
from ..core.serialize import g1_from_bytes, g1_to_bytes
from ..errors import CommitmentError, PolynomialError
from ..field.fr import MODULUS, Fr, batch_inverse
from ..field.g1 import G1
from ..field.pairing import pairing, pairing_product_is_one
from ..poly.interp import evaluate_polynomial, interpolate_on_range
from ..utils.profiling import span
from .msm_sched import num_scalars

#: An MSM over a native-resident SRS goes to the device from this many
#: points up.  It is the size at which ``MultilinearKZG.commit_many``
#: starts batching columns; at T = 2^16 it puts all 24 column commitments
#: of a TwistBits proof and the six largest quotient MSMs of each opening
#: on the device and leaves the short tail of each opening on the host.
DEVICE_MSM_MIN = 1024

_ROUTES = ("device", "host")
_route_counts: Dict[str, int] = dict.fromkeys(_ROUTES, 0)
#: (srs_id, device) -> ScheduledMsmContext
_device_contexts: dict = {}
#: hazards of the one-call contexts ``msm`` builds over explicit points
_explicit_hazards = 0


def route_counts() -> Dict[str, int]:
    """MSMs through the router since the last reset, by route: ``device``
    and ``host`` (fewer than ``DEVICE_MSM_MIN`` points)."""
    return dict(_route_counts)


def reset_route_counts() -> None:
    for k in _ROUTES:
        _route_counts[k] = 0


def device_srs_context(srs_id: int, device):
    """The device-resident copy of a native SRS, built on first use."""
    from .msm_sched import ScheduledMsmContext

    device = torch.device(device)
    key = (srs_id, device)
    ctx = _device_contexts.get(key)
    if ctx is None:
        with span("bases"):
            ctx = ScheduledMsmContext.from_native_srs(srs_id, device=device)
        _device_contexts[key] = ctx
    return ctx


def device_contexts() -> list:
    """Every device SRS context built so far (for hazard counts)."""
    return list(_device_contexts.values())


def hazard_count() -> int:
    """Lanes whose accumulator met its own point, over every device MSM so
    far: those of the SRS contexts and of the one-call contexts ``msm``
    builds over explicit points."""
    return (sum(c.hazard_count for c in _device_contexts.values())
            + _explicit_hazards)


def srs_msm_async(srs_id: int, scalars, device) -> Callable[[], G1]:
    """Dispatch one MSM over a native SRS and return its finisher.

    The device work is launched before this returns and waited for in the
    finisher, so a caller with several MSMs dispatches them all before it
    finishes any.  A host MSM runs in the finisher, as a ``host_msm``
    span."""
    from .. import _native

    if num_scalars(scalars) < DEVICE_MSM_MIN:
        _route_counts["host"] += 1

        def finish() -> G1:
            with span("host_msm"):
                return _native.srs_msm(srs_id, scalars)
        return finish
    _route_counts["device"] += 1
    return device_srs_context(srs_id, device).msm_async(scalars)


def srs_msm_many(srs_id: int, scalars_list, device) -> List[G1]:
    """A batch of MSMs over one native SRS: every MSM is dispatched before
    any is waited for."""
    fins = [srs_msm_async(srs_id, s, device) for s in scalars_list]
    return [fin() for fin in fins]


def msm(points: Sequence[G1], scalars: Sequence[Fr], device) -> G1:
    """Σ s_i · P_i through the router of the module docstring, over a
    native-resident SRS (``NativeSRS``) or explicit points (whose bases
    are packed and uploaded for this one call)."""
    if isinstance(points, NativeSRS):
        return srs_msm_async(points.srs_id, scalars, device)()
    n = min(len(points), num_scalars(scalars))
    if n < DEVICE_MSM_MIN:
        from .. import _native

        _route_counts["host"] += 1
        with span("host_msm"):
            return host_msm(points, scalars, native=_native.available)
    from .msm_sched import ScheduledMsmContext

    global _explicit_hazards
    _route_counts["device"] += 1
    if isinstance(scalars, (bytes, bytearray)):
        scalars = scalars[:32 * n]
    elif isinstance(scalars, torch.Tensor):
        scalars = scalars[:n]
    else:
        scalars = list(scalars[:n])
    with span("bases"):
        ctx = ScheduledMsmContext(points[:n], device=device)
    out = ctx.msm(scalars)
    _explicit_hazards += ctx.hazard_count
    return out


def host_msm(points: Sequence[G1], scalars: Sequence[Fr],
             native: bool = True) -> G1:
    """Σ s_i · P_i over explicit points on the host: the native Pippenger,
    or with ``native=False`` the pure-Python bucket method (the golden
    path).  Both give the same element."""
    if isinstance(scalars, (bytes, bytearray)):
        scalars = [
            Fr(int.from_bytes(scalars[32 * i:32 * i + 32], "little"))
            for i in range(len(scalars) // 32)
        ]
    n = min(len(points), len(scalars))
    if n >= 4 and native:
        from .. import _native

        return _native.msm(points[:n], scalars[:n])
    pairs = [(points[i], int(scalars[i])) for i in range(n) if int(scalars[i])]
    if not pairs:
        return G1.zero()
    if len(pairs) <= 4:
        acc = G1.zero()
        for p, s in pairs:
            acc = acc.add(p.scalar_mul(s))
        return acc
    c = max(2, len(pairs).bit_length() - 1)
    c = min(c, 13)
    num_windows = (254 + c - 1) // c
    mask = (1 << c) - 1
    result = G1.zero()
    for w in range(num_windows - 1, -1, -1):
        if not result.is_zero():
            for _ in range(c):
                result = result.double()
        buckets: List[G1] = [G1.zero()] * (mask + 1)
        shift = w * c
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = buckets[d].add(p)
        acc = G1.zero()
        running = G1.zero()
        for d in range(mask, 0, -1):
            running = running.add(buckets[d])
            acc = acc.add(running)
        result = result.add(acc)
    return result


@dataclass
class KZGCommitmentValue:
    """A KZG commitment: a point in G1."""

    commitment: G1

    def hash(self) -> Fr:
        """Affine x-coordinate LE bytes, reduced into Fr."""
        x, _ = self.commitment.to_affine()
        return Fr.from_le_bytes_mod_order(x.to_bytes(32, "little"))

    def serialize_compressed(self) -> bytes:
        return g1_to_bytes(self.commitment, compress=True)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "KZGCommitmentValue":
        return cls(g1_from_bytes(data, compressed=True))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, KZGCommitmentValue):
            return NotImplemented
        return self.commitment == other.commitment


@dataclass
class KZGProof:
    """A KZG opening proof: a point in G1."""

    proof: G1

    def serialize_compressed(self) -> bytes:
        return g1_to_bytes(self.proof, compress=True)

    @classmethod
    def deserialize_compressed(cls, data: bytes) -> "KZGProof":
        return cls(g1_from_bytes(data, compressed=True))


# ---------------------------------------------------------------------------
# Lagrange SRS over the domain {0..n-1}  (evaluation-basis KZG)
# ---------------------------------------------------------------------------
#
# C = [P(tau)]_1 = sum_i v_i [L_i(tau)]_1, so with the Lagrange SRS
# {[L_i(tau)]_1} a commitment is one MSM over the raw values, and the
# opening quotient at z is evaluation-local: Q(i) = (v_i - P(z)) / (i - z),
# P(z) by barycentric evaluation.  The group elements are those of the
# coefficient-basis path (same polynomial), so transcripts do not change.
# L_i(tau) = prod_{j != i} (tau - j) / ((-1)^(n-1-i) i! (n-1-i)!).

@lru_cache(maxsize=64)
def _range_factorial_denoms(n: int) -> tuple:
    """denom_i = (-1)^(n-1-i) * i! * (n-1-i)!  for the domain {0..n-1}."""
    fact = [1] * n
    for k in range(1, n):
        fact[k] = fact[k - 1] * k % MODULUS
    out = []
    for i in range(n):
        d = fact[i] * fact[n - 1 - i] % MODULUS
        if (n - 1 - i) % 2 == 1:
            d = MODULUS - d
        out.append(Fr(d))
    return tuple(out)


def lagrange_srs(params: CommitmentParams, n: int):
    """[L_i(tau)]_1 for the domain {0..n-1}, cached on the params object:
    with the native engine a ``NativeSRS`` at every n, so that the router
    uploads it once per handle and device (the JAX package keeps explicit
    points up to 2^14; the elements are the same), else a list of ``G1``."""
    from .. import _native

    cache = getattr(params, "_lagrange_srs_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(params, "_lagrange_srs_cache", cache)
    if n in cache:
        return cache[n]
    if params.tau is None:
        raise CommitmentError("Lagrange SRS requires tau in params")
    g = G1.generator()
    if _native.available:
        # L_i(tau) computed natively; the bytes stay native-side through
        # the fixed-base build
        scalar_bytes = _native.fr_lagrange_tau(params.tau, n)
        points = NativeSRS(_native.srs_create_fixed_base(g, scalar_bytes))
        cache[n] = points
        return points

    tau = int(params.tau)
    t = [Fr((tau - i) % MODULUS) for i in range(n)]
    prefix = [Fr(1)] * (n + 1)
    for i in range(n):
        prefix[i + 1] = prefix[i] * t[i]
    denoms = _range_factorial_denoms(n)
    inv_dt = batch_inverse([denoms[i] * t[i] for i in range(n)])
    full = prefix[n]  # prod (tau - j)
    points = [g.scalar_mul(full * inv_dt[i]) for i in range(n)]
    cache[n] = points
    return points


@lru_cache(maxsize=64)
def _barycentric_weights(n: int) -> tuple:
    """w_i = 1 / denom_i for the domain {0..n-1}."""
    return tuple(batch_inverse(list(_range_factorial_denoms(n))))


def barycentric_eval(values: Sequence[Fr], z: Fr) -> Fr:
    """P(z) for the interpolant of ``values`` on {0..n-1}; z not in domain."""
    n = len(values)
    if n == 0:
        return Fr(0)
    zi = int(z)
    diffs = [Fr((zi - i) % MODULUS) for i in range(n)]
    inv_diffs = batch_inverse(diffs)
    weights = _barycentric_weights(n)
    acc = 0
    for i in range(n):
        acc += int(values[i]) * int(weights[i]) * int(inv_diffs[i])
    full = 1
    for d in diffs:
        full = full * int(d) % MODULUS
    return Fr(acc % MODULUS * full)


# ---------------------------------------------------------------------------
# Scheme interface
# ---------------------------------------------------------------------------

class CommitmentScheme(ABC):
    """Abstract polynomial commitment scheme; committing and opening run
    their MSMs on ``device``."""

    @staticmethod
    @abstractmethod
    def commit(params, polynomial: Sequence[Fr], device):
        ...

    @staticmethod
    @abstractmethod
    def open(params, polynomial: Sequence[Fr], point: Fr, device):
        ...

    @staticmethod
    @abstractmethod
    def verify(vk, commitment, point: Fr, value: Fr, proof) -> bool:
        ...

    @classmethod
    def batch_verify(cls, vk, commitments, points, values, proofs) -> bool:
        """Default: verify each proof individually."""
        for c, z, v, pi in zip(commitments, points, values, proofs):
            if not cls.verify(vk, c, z, v, pi):
                return False
        return True


# ---------------------------------------------------------------------------
# Polynomial helpers
# ---------------------------------------------------------------------------

def compute_quotient_polynomial(
    poly: Sequence[Fr], point: Fr, value: Fr
) -> List[Fr]:
    """(P(x) - v) / (x - z) by synthetic division, highest coefficient
    first; a constant or empty polynomial gives the empty quotient.  The
    remainder P(z) - v is assumed 0 and not checked, as in the reference."""
    if len(poly) <= 1:
        return []
    n = len(poly)
    q: List[Fr] = [Fr(0)] * (n - 1)
    carry = Fr(poly[n - 1])
    for i in range(n - 2, -1, -1):
        q[i] = carry
        carry = Fr(poly[i]) + carry * point
    return q


def polynomial_division(
    dividend: Sequence[Fr], divisor: Sequence[Fr]
) -> List[Fr]:
    """General long division returning the quotient."""
    if len(divisor) == 0 or all(int(x) == 0 for x in divisor):
        raise PolynomialError("Cannot divide by zero polynomial")
    divisor_degree = len(divisor) - 1
    leading = Fr(divisor[divisor_degree])
    if leading.is_zero():
        raise PolynomialError("Divisor must have non-zero leading coefficient")
    leading_inv = leading.inverse()
    remainder = [Fr(x) for x in dividend]
    if len(remainder) < len(divisor):
        return []
    quotient_degree = len(remainder) - len(divisor)
    quotient = [Fr(0)] * (quotient_degree + 1)
    for i in range(quotient_degree, -1, -1):
        if len(remainder) > i + divisor_degree:
            coeff = remainder[i + divisor_degree] * leading_inv
            quotient[i] = coeff
            for j in range(len(divisor)):
                if i + j < len(remainder):
                    remainder[i + j] = remainder[i + j] - coeff * divisor[j]
    return quotient


# ---------------------------------------------------------------------------
# The univariate KZG scheme
# ---------------------------------------------------------------------------

class KZGCommitment(CommitmentScheme):
    """KZG over BN254 with the trusted setup from ``setup_params``."""

    @staticmethod
    def commit(params: CommitmentParams, polynomial: Sequence[Fr],
               device) -> KZGCommitmentValue:
        if len(polynomial) > len(params.g1_powers):
            raise CommitmentError("Polynomial degree exceeds setup size")
        if isinstance(params.g1_powers, NativeSRS):
            return KZGCommitmentValue(
                msm(params.g1_powers, polynomial, device))
        return KZGCommitmentValue(
            msm(params.g1_powers[: len(polynomial)], polynomial, device))

    @staticmethod
    def open(params: CommitmentParams, polynomial: Sequence[Fr], point: Fr,
             device) -> Tuple[Fr, KZGProof]:
        value = evaluate_polynomial(polynomial, point)
        quotient = compute_quotient_polynomial(polynomial, point, value)
        proof_commitment = KZGCommitment.commit(params, quotient, device)
        return value, KZGProof(proof_commitment.commitment)

    # -- evaluation-basis path (identical group elements) ------------------
    @staticmethod
    def commit_evals(params: CommitmentParams, values: Sequence[Fr],
                     device) -> KZGCommitmentValue:
        """Commit to the interpolant of ``values`` over {0..n-1} without
        interpolating: one MSM against the Lagrange SRS.  The same
        commitment as ``commit(interpolate_on_range(values))``."""
        n = len(values)
        if n == 0:
            return KZGCommitmentValue(G1.zero())
        if n > len(params.g1_powers):
            raise CommitmentError("Polynomial degree exceeds setup size")
        if params.tau is None:
            poly = interpolate_on_range([Fr(v) for v in values])
            return KZGCommitment.commit(params, poly, device)
        return KZGCommitmentValue(
            msm(lagrange_srs(params, n), values, device))

    @staticmethod
    def open_evals(params: CommitmentParams, values: Sequence[Fr],
                   point: Fr, device) -> Tuple[Fr, KZGProof]:
        """Open the interpolant of ``values`` at ``point`` in O(n) field
        work: barycentric evaluation and an evaluation-local quotient.
        Falls back to the coefficient path if ``point`` lies in the domain
        or tau is unavailable."""
        from .. import _native

        n = len(values)
        zi = int(point)
        if n < 2 or zi < n or params.tau is None:
            poly = interpolate_on_range([Fr(v) for v in values])
            return KZGCommitment.open(params, poly, point, device)
        if _native.available:
            # the value and the quotient in one native pass; the quotient's
            # bytes go to the MSM as they are
            value, q_bytes = _native.fr_open_evals(values, point)
            return value, KZGProof(
                msm(lagrange_srs(params, n), q_bytes, device))
        diffs = [Fr((i - zi) % MODULUS) for i in range(n)]
        inv_diffs = batch_inverse(diffs)
        value = barycentric_eval(values, point)
        q = [(Fr(values[i]) - value) * inv_diffs[i] for i in range(n)]
        proof_commitment = KZGCommitment.commit_evals(params, q, device)
        return value, KZGProof(proof_commitment.commitment)

    @staticmethod
    def verify(vk: CommitmentVerificationKey, commitment: KZGCommitmentValue,
               point: Fr, value: Fr, proof: KZGProof) -> bool:
        """Pairing check e(C - [v]_1, [1]_2) == e(pi, [tau]_2 - [z]_2), on
        the native pairing (one shared final exponentiation) where the
        engine is on."""
        from .. import _native

        if _native.available:
            left_g1 = commitment.commitment - _native.g1_scalar_mul(
                vk.g1_generator, value)
            right_g2 = vk.g2_tau - _native.g2_scalar_mul(
                vk.g2_generator, point)
            return _native.pairing_equal(
                left_g1, vk.g2_generator, proof.proof, right_g2)
        left_g1 = commitment.commitment - vk.g1_generator.scalar_mul(value)
        right_g2 = vk.g2_tau - vk.g2_generator.scalar_mul(point)
        return pairing(left_g1, vk.g2_generator) == pairing(
            proof.proof, right_g2)

    @staticmethod
    def batch_verify(vk: CommitmentVerificationKey,
                     commitments: Sequence[KZGCommitmentValue],
                     points: Sequence[Fr], values: Sequence[Fr],
                     proofs: Sequence[KZGProof]) -> bool:
        """RLC batch verification as the reference writes it.

        The reference's pairing equation is unbalanced in the RLC weights
        (the left side is linear in gamma, the right side quadratic), so it
        rejects honest non-empty batches.  Kept as it is, with the fixed
        [42u8; 32]-seeded gammas (not the transcript);
        ``batch_verify_sound`` is the correct batch check."""
        if not (len(commitments) == len(points) == len(values) == len(proofs)):
            raise CommitmentError("Batch verify input lengths must match")
        if len(commitments) == 0:
            return True
        from ..field.g2 import G2

        rng = ChaCha20Rng.from_seed(bytes([42]) * 32)
        gammas = [fr_rand(rng) for _ in commitments]
        batched_commitment = G1.zero()
        for cval, gamma in zip(commitments, gammas):
            batched_commitment = batched_commitment.add(
                cval.commitment.scalar_mul(gamma))
        batched_value = Fr(0)
        for v, gamma in zip(values, gammas):
            batched_value = batched_value + v * gamma
        batched_proof = G1.zero()
        for pi, gamma in zip(proofs, gammas):
            batched_proof = batched_proof.add(pi.proof.scalar_mul(gamma))
        left_g1 = batched_commitment - vk.g1_generator.scalar_mul(
            batched_value)
        batched_g2 = G2.zero()
        for z, gamma in zip(points, gammas):
            term = (vk.g2_tau - vk.g2_generator.scalar_mul(z)).scalar_mul(
                gamma)
            batched_g2 = batched_g2.add(term)
        return pairing(left_g1, vk.g2_generator) == pairing(
            batched_proof, batched_g2)

    @staticmethod
    def batch_verify_sound(vk: CommitmentVerificationKey,
                           commitments: Sequence[KZGCommitmentValue],
                           points: Sequence[Fr], values: Sequence[Fr],
                           proofs: Sequence[KZGProof]) -> bool:
        """Correct RLC batch verification: with the identity
        ``C_i - v_i G + z_i pi_i == tau * pi_i`` in the exponent,

            e(sum gamma_i (C_i - v_i G + z_i pi_i), [1]_2)
              == e(sum gamma_i pi_i, [tau]_2)

        holds iff every opening is valid (up to the RLC soundness error)."""
        from .. import _native

        if not (len(commitments) == len(points) == len(values) == len(proofs)):
            raise CommitmentError("Batch verify input lengths must match")
        if len(commitments) == 0:
            return True
        rng = ChaCha20Rng.from_seed(bytes([42]) * 32)
        gammas = [fr_rand(rng) for _ in commitments]
        left = G1.zero()
        right_proof = G1.zero()
        for cval, z, v, pi, gamma in zip(commitments, points, values, proofs,
                                         gammas):
            term = (cval.commitment - vk.g1_generator.scalar_mul(v)
                    + pi.proof.scalar_mul(z))
            left = left.add(term.scalar_mul(gamma))
            right_proof = right_proof.add(pi.proof.scalar_mul(gamma))
        pairs = [(left, vk.g2_generator), (right_proof.neg(), vk.g2_tau)]
        if _native.available:
            return _native.pairing_product_is_one(pairs)
        return pairing_product_is_one(pairs)


def verify_openings_batched(vk: CommitmentVerificationKey,
                            commitments: Sequence[KZGCommitmentValue],
                            point: Fr, values: Sequence[Fr],
                            proofs: Sequence[KZGProof]) -> bool:
    """Several openings at the same point checked with one pairing product.

    Each opening satisfies e(C_i - v_i G, [1]_2) == e(pi_i, T) with the
    shared T = [tau]_2 - [z]_2.  With weights gamma^i from a transcript over
    the statement, the combined check

        e(sum gamma^i (C_i - v_i G), [1]_2) * e(-sum gamma^i pi_i, T) == 1

    costs 2 Miller loops and 1 final exponentiation.  gamma depends on all
    commitments, values and proofs, so a forged opening survives with
    probability about 1/r."""
    from .. import _native
    from ..core.transcript import Transcript

    if not (len(commitments) == len(values) == len(proofs)):
        raise CommitmentError("batched opening inputs must match in length")
    if len(commitments) == 0:
        return True
    t = Transcript(bytes(32))
    t.append_field_element(b"batch_point", point)
    for cval, v in zip(commitments, values):
        t.append_field_element(b"batch_commitment", cval.hash())
        t.append_field_element(b"batch_value", v)
    for pi in proofs:
        t.append_field_element(
            b"batch_proof", KZGCommitmentValue(pi.proof).hash())
    gamma = t.challenge_field_element(b"batch_gamma")

    def weighted(p: G1, s: Fr) -> G1:
        if int(s) == 1:
            return p
        if _native.available:
            return _native.g1_scalar_mul(p, s)
        return p.scalar_mul(s)

    acc_c = G1.zero()
    acc_v = Fr(0)
    acc_p = G1.zero()
    weight = Fr(1)
    for cval, v, pi in zip(commitments, values, proofs):
        acc_c = acc_c.add(weighted(cval.commitment, weight))
        acc_v = acc_v + v * weight
        acc_p = acc_p.add(weighted(pi.proof, weight))
        weight = weight * gamma
    left = acc_c - weighted(vk.g1_generator, acc_v)
    right_g2 = vk.g2_tau - vk.g2_generator.scalar_mul(point)
    if _native.available:
        return _native.pairing_equal(left, vk.g2_generator, acc_p, right_g2)
    return pairing(left, vk.g2_generator) == pairing(acc_p, right_g2)


# ---------------------------------------------------------------------------
# Vector commitments
# ---------------------------------------------------------------------------

class VectorCommitmentScheme(ABC):
    """Abstract vector commitment scheme."""

    @staticmethod
    @abstractmethod
    def commit(params, vector: Sequence[Fr], device):
        ...

    @staticmethod
    @abstractmethod
    def open(params, vector: Sequence[Fr], index: int, device):
        ...

    @staticmethod
    @abstractmethod
    def verify(vk, commitment, index: int, value: Fr, proof) -> bool:
        ...


class KZGVectorCommitment(VectorCommitmentScheme):
    """Vector commitment: KZG over the interpolant of the vector on
    {0..n-1}."""

    @staticmethod
    def commit(params: CommitmentParams, vector: Sequence[Fr],
               device) -> KZGCommitmentValue:
        poly = interpolate_on_range([Fr(v) for v in vector])
        return KZGCommitment.commit(params, poly, device)

    @staticmethod
    def open(params: CommitmentParams, vector: Sequence[Fr], index: int,
             device) -> Tuple[Fr, KZGProof]:
        if index >= len(vector):
            raise CommitmentError("Index out of bounds")
        value = Fr(vector[index])
        poly = interpolate_on_range([Fr(v) for v in vector])
        opened_value, proof = KZGCommitment.open(params, poly, Fr(index),
                                                 device)
        if opened_value != value:
            raise CommitmentError("Opened value does not match vector entry")
        return value, proof

    @staticmethod
    def verify(vk: CommitmentVerificationKey, commitment: KZGCommitmentValue,
               index: int, value: Fr, proof: KZGProof) -> bool:
        return KZGCommitment.verify(vk, commitment, Fr(index), value, proof)
