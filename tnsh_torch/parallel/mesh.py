"""The mesh on ``torch.distributed``: hypercube-sharded MLEs, sharded
sum-check oracles and a sharded MSM, the port of ``tnsh.parallel.mesh``.

A rank takes the place of a JAX device: each rank holds its block of
lanes on its own device and runs the port's kernels on that block, and
the ranks meet only in ``torch.distributed`` collectives.  The backend
follows the device: NCCL where each rank has a card of its own, gloo on
the CPU.  Ranks that share one card run gloo over CUDA tensors (NCCL
refuses two ranks on one GPU); gloo stages those few bytes through the
host itself.

  * **MLE tables** ``(8, N)`` are block-sharded on the lane axis.  Lanes
    are little-endian hypercube indices, so a block fixes the SLOWEST
    variables, and folding variable 0 (lane pairs ``(2i, 2i+1)``) stays
    inside the block: no communication, each block halves.
  * **Round evaluations** are the block's partial sums followed by one
    exact field sum over the ranks (``psum_field``): an int64 all-reduce of
    the 32-bit limbs, then a carry normalization and a reduction mod p on
    the rank's device.
  * Once a block is down to one lane (or, for the sums of products,
    after ``max_sharded_rounds`` binds), the ranks ``all_gather`` the
    folded tables and finish unsharded on the kernels of the rank's
    device.  tnsh finishes its sums of products on the host.
  * **MSM**: each rank runs the port's MSM (``commit.kzg.msm``: the
    insertion and tail kernels from 1024 points, the native host MSM
    below) over its block of points; the ranks' partial points are
    all-gathered and summed by ``msm_group.tree_reduce_points`` on the
    Jacobian add kernel.

Every rank computes the same round polynomials and the same transcript,
so every rank's proof bytes equal the unsharded oracles'.

Where the port differs from tnsh:

  * ``init_distributed`` raises on any failure but an existing process
    group (tnsh swallows ``RuntimeError`` / ``ValueError``): a failed
    NCCL start must not leave a run that looks single-process.
  * ``ShardedSparseCubeOracle`` runs ONE slice a rank, the design tnsh's
    docstring gives for a pod; tnsh runs every slice in one process, on
    its Python k phase (its engine takes no seeded colinc scan; the
    port's does).
  * The sums of products finish their gathered tails on the rank's
    device, not on the host.
  * The step functions are plain functions of a ``Mesh`` and the rank's
    block (tnsh caches its jitted steps: PyTorch has nothing to trace).
  * The MSM partial of a rank is the scheduled Pippenger's, not tnsh's
    254-step double-and-add: the same group element.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..errors import SumCheckError
from ..field import fr_kernels, limbs
from ..field.fr import MODULUS, Fr
from ..field.limbs import FQ_SPEC, LIMB_BITS, NUM_LIMBS
from ..iop.sumcheck import SumcheckOracle
from ..iop.sumcheck_d import TorchSopOracleD, stack_tables
from ..poly import mle

_P = MODULUS
_MASK = (1 << LIMB_BITS) - 1

#: The most values ``psum_field`` sums: each int64 limb sum stays below
#: 2^63 while fewer than 2^31 limbs of 32 bits are added.
MAX_PSUM_TERMS = (1 << 31) - 1

#: How long ``run_ranks`` waits for its ranks' results, seconds.
RANKS_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------

@dataclass
class Mesh:
    """One axis of ranks: the process group, this rank, the group's size,
    the device this rank's blocks live on, the collectives it ran (their
    count and host seconds, each waited for), and the host seconds of its
    ``psum_field`` calls (collective and reduction, waited for)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = "data"
    collectives: int = 0
    collective_s: float = 0.0
    psum_s: float = 0.0


class Mesh2D(NamedTuple):
    """A (dcn, ici) layout: ``ici`` is the fast axis (ranks of one host),
    ``dcn`` the slow one (one rank of each host)."""

    dcn: Mesh
    ici: Mesh


def _rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``None`` or ``"cuda"`` picks the rank's card
    (``LOCAL_RANK`` where ``torchrun`` sets it); the CPU only on request."""
    if device is not None:
        device = torch.device(device)
    if device is None or device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the mesh on the "
                "CPU")
        if device is None or device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, device,
                     backend: Optional[str] = None) -> None:
    """Join the default process group, once a process.

    The arguments default to ``env://``, the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` that ``torchrun`` sets.  The
    backend follows ``device``: ``nccl`` on ``cuda``, ``gloo`` on ``cpu``;
    ``backend=`` overrides it (``gloo`` for ranks that share a card).  A
    no-op when a group exists; any other failure raises."""
    if dist.is_initialized():
        return
    me = int(os.environ.get("RANK", 0)) if rank is None else rank
    dev = _rank_device(device, me)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def make_mesh(device=None, axis: str = "data", group=None) -> Mesh:
    """A 1-D mesh over the ranks of ``group`` (the default group's when
    ``None``).  ``device`` defaults to the rank's card; the CPU only on
    request."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs init_distributed first")
    rank = dist.get_rank(group)
    return Mesh(group, rank, dist.get_world_size(group),
                _rank_device(device, dist.get_rank()), axis)


def make_mesh_2d(ici: int, dcn: int, device=None, ici_axis: str = "ici",
                 dcn_axis: str = "dcn") -> Mesh2D:
    """The (dcn, ici) subgroups of ``ici * dcn`` ranks, rank = d * ici + i.
    Every rank creates every group, in the same order.  A sum over both
    axes is ``psum_field(psum_field(x, m.ici), m.dcn)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs init_distributed first")
    world, me = dist.get_world_size(), dist.get_rank()
    if ici * dcn != world:
        raise ValueError(f"ici * dcn = {ici * dcn} ranks, the world has "
                         f"{world}")
    dev = _rank_device(device, me)
    mine = {}
    for d in range(dcn):
        ranks = [d * ici + i for i in range(ici)]
        g = dist.new_group(ranks)
        if me in ranks:
            mine[ici_axis] = Mesh(g, ranks.index(me), ici, dev, ici_axis)
    for i in range(ici):
        ranks = [d * ici + i for d in range(dcn)]
        g = dist.new_group(ranks)
        if me in ranks:
            mine[dcn_axis] = Mesh(g, ranks.index(me), dcn, dev, dcn_axis)
    return Mesh2D(mine[dcn_axis], mine[ici_axis])


def _rank_main(rank: int, n_ranks: int, device, backend, init_method: str,
               fn, args, results) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, report."""
    try:
        init_distributed(init_method, n_ranks, rank, device=device,
                         backend=backend)
        results.put((rank, True, fn(make_mesh(device), *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, device, backend: Optional[str] = None,
              args=()) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned processes
    (``torch.multiprocessing``, a ``FileStore`` in the build directory)
    and return their results in rank order.

    ``fn`` is a module-level function (a spawned process imports its
    module) and returns something picklable.  ``device`` is each rank's:
    ``"cpu"``, a card (``"cuda:0"``: every rank on it, which needs
    ``backend="gloo"``), or ``"cuda"`` (rank r on card r mod count).  A
    rank that raises, dies or outlasts ``RANKS_TIMEOUT_S`` fails the run
    with its traceback; every process started is stopped before this
    returns."""
    from .._build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="mesh-", dir=BUILD_DIR)
    init_method = "file://" + os.path.join(store_dir, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, device, backend, init_method, fn,
                               tuple(args), results))
             for r in range(n_ranks)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while len(out) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the ranks ran past {RANKS_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0 if len(out) == n_ranks else 1.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(n_ranks)]


# ---------------------------------------------------------------------------
# Collectives (timed and counted on the mesh)
# ---------------------------------------------------------------------------

def _timed(mesh: Mesh, op):
    start = time.perf_counter()
    out = op()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.collectives += 1
    mesh.collective_s += time.perf_counter() - start
    return out


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> None:
    _timed(mesh, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                         group=mesh.group))


def _all_gather(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    _timed(mesh, lambda: dist.all_gather(out, t, group=mesh.group))
    return out


def _gather_lanes(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks joined along the lane (last) axis."""
    return torch.cat(_all_gather(mesh, t), dim=-1).contiguous()


def _ints_tensor(values: Sequence[int], device) -> torch.Tensor:
    """Canonical field values as ``(8, n)`` int32 words (no Montgomery)."""
    return torch.from_numpy(limbs.canonical_words(list(values))).to(device)


# ---------------------------------------------------------------------------
# Exact field psum: an int64 limb all-reduce + renormalization
# ---------------------------------------------------------------------------

def _renorm_mod(s: torch.Tensor, terms: int) -> torch.Tensor:
    """Limb sums of ``terms`` values below 2^256 -> the sum mod p.

    ``s`` is ``(8, n)`` int64: limb i of every lane is the sum of the
    values' 32-bit limbs i, each sum below terms * 2^32.  A carry
    normalization gives the lane's value < terms * 2^256 in nine 32-bit
    limbs; conditional subtractions of p * 2^k, k from the largest that
    can fit down to 0, leave it in [0, p).  Returns ``(8, n)`` int32 raw
    limbs: the sum of Montgomery residues is the residue of the sum, so a
    Montgomery input gives the Montgomery form of the sum.

    The limit is ``MAX_PSUM_TERMS`` = 2^31 - 1 values (ranks), where the
    int64 limb sums would overflow; tnsh's 22 x 12-bit layout stops at 256
    devices."""
    if not 1 <= terms <= MAX_PSUM_TERMS:
        raise ValueError(f"psum of {terms} values: the limit is 1 .. "
                         f"{MAX_PSUM_TERMS}")
    rows = []
    carry = torch.zeros_like(s[0])
    for i in range(NUM_LIMBS):
        v = s[i] + carry
        rows.append(v & _MASK)
        carry = v >> LIMB_BITS
    rows.append(carry)                     # < terms: the ninth limb
    bound = terms << (LIMB_BITS * NUM_LIMBS)
    k = 0
    while (_P << (k + 1)) < bound:
        k += 1
    for shift in range(k, -1, -1):
        m = _P << shift
        diff = []
        borrow = torch.zeros_like(rows[0])
        for i in range(NUM_LIMBS + 1):
            v = rows[i] - ((m >> (LIMB_BITS * i)) & _MASK) - borrow
            borrow = (v < 0).to(v.dtype)
            diff.append(v + (borrow << LIMB_BITS))
        ge = borrow == 0
        rows = [torch.where(ge, d, r) for d, r in zip(diff, rows)]
    out = torch.stack(rows[:NUM_LIMBS])
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def psum_field(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The exact field sum of every rank's ``(8, n)`` limb planes, on every
    rank; values in [0, p)."""
    start = time.perf_counter()
    s = x.to(torch.int64) & _MASK
    _all_reduce_sum(mesh, s)
    out = _renorm_mod(s, mesh.size)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.psum_s += time.perf_counter() - start
    return out


def _psum_ints(mesh: Mesh, values: Sequence[int]) -> List[int]:
    """``psum_field`` of host field values, as canonical ints."""
    out = psum_field(_ints_tensor(values, mesh.device), mesh)
    return limbs.raw_ints(out)


# ---------------------------------------------------------------------------
# Sharded steps (the rank's block in, the kernels of its device)
# ---------------------------------------------------------------------------

def sharded_round_step(mesh: Mesh, tables: torch.Tensor, r):
    """One product round on the block: ([g(0..3)] summed over the ranks,
    ``(8, 4)``, and the block's tables folded at ``r``)."""
    return sharded_evals_step(mesh, tables), sharded_fold_step(
        mesh, tables, r)


def sharded_fold_step(mesh: Mesh, tables: torch.Tensor, r) -> torch.Tensor:
    """The block's ``(F, 8, n)`` tables folded at ``r``: no collective."""
    return mle.fold(tables, r)


def sharded_evals_step(mesh: Mesh, tables: torch.Tensor) -> torch.Tensor:
    """[g(0..3)] of the product of the ``(F, 8, n)`` tables, the block's
    partial sums summed over the ranks."""
    return psum_field(mle.product_round_evals(tables), mesh)


def sharded_sop_evals_step(mesh: Mesh, tables: torch.Tensor, coeffs,
                           term_idxs) -> torch.Tensor:
    """[g(0..3)] of Σ_t c_t Π T_f over the block, summed over the ranks."""
    return psum_field(
        mle.sum_of_products_round_evals(tables, coeffs, term_idxs), mesh)


def sharded_sopd_evals_step(mesh: Mesh, tables: torch.Tensor, coeffs,
                            term_idxs, npts: int) -> torch.Tensor:
    """[g(0..npts-1)] of Σ_t c_t Π T_f over the block, summed over the
    ranks."""
    return psum_field(mle.sum_of_products_round_evals_d(
        tables, coeffs, term_idxs, npts), mesh)


def block(mesh: Mesh, n: int) -> Tuple[int, int]:
    """The lanes ``[lo, hi)`` of ``n`` that this rank holds."""
    if n < mesh.size or n % mesh.size:
        raise SumCheckError(f"{n} lanes do not split into {mesh.size} "
                            "blocks of at least one lane")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _check_world(mesh: Mesh) -> None:
    if mesh.size & (mesh.size - 1):
        raise SumCheckError("mesh device count must be a power of two")


def _upload(tables, lo: int, hi: int, device) -> torch.Tensor:
    """Lanes ``[lo, hi)`` of each table (host values or an ``(8, N)``
    tensor) as one ``(F, 8, hi - lo)`` tensor on ``device``."""
    return stack_tables([t[:, lo:hi] if isinstance(t, torch.Tensor)
                         else t[lo:hi] for t in tables], device)


# ---------------------------------------------------------------------------
# Sharded oracles
# ---------------------------------------------------------------------------

class ShardedProductMLEOracle(SumcheckOracle):
    """Product of MLE factors, hypercube-sharded: each round is the
    block's round evaluations plus one ``psum_field``, each bind a fold of
    the block.  Every rank gets all the factors and uploads its block.
    Once a block would drop under 2 lanes, the ranks gather the folded
    tables and the last rounds run unsharded on the rank's device.
    Proofs are bit-identical to ``ProductMLEOracle``'s."""

    def __init__(self, factors, mesh: Mesh = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        _check_world(self.mesh)
        if not factors:
            raise SumCheckError("ShardedProductMLEOracle needs >= 1 factor")
        self.num_vars = factors[0].num_vars
        for f in factors:
            if f.num_vars != self.num_vars:
                raise SumCheckError("factor num_vars mismatch")
        lo, hi = block(self.mesh, 1 << self.num_vars)
        self.tables = _upload([f.evaluations for f in factors], lo, hi,
                              self.mesh.device)
        self._gathered = False

    def _sharded_ok(self) -> bool:
        return not self._gathered and self.tables.shape[-1] >= 2

    def _gather(self) -> None:
        if not self._gathered:
            self.tables = _gather_lanes(self.mesh, self.tables)
            self._gathered = True

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._sharded_ok():
            evals = sharded_evals_step(self.mesh, self.tables)
        else:
            self._gather()
            evals = mle.product_round_evals(self.tables)
        return mle.unpack_fr(evals)

    def bind(self, challenge) -> None:
        if self._sharded_ok():
            self.tables = sharded_fold_step(self.mesh, self.tables, challenge)
        else:
            self._gather()
            self.tables = mle.fold(self.tables, challenge)

    def final_evaluation(self, challenges) -> Fr:
        self._gather()
        prod = 1
        for v in limbs.unpack(self.tables[:, :, 0].transpose(0, 1)):
            prod = prod * v % _P
        return Fr(prod)


class _ShardedSop(TorchSopOracleD, SumcheckOracle):
    """Σ_t coeff_t Π T_{t,m} on the mesh: the two sum-of-products oracles'
    common body, a ``TorchSopOracleD`` over the rank's block (its tables,
    coefficients and round program).  A round is the block's partial sums
    plus one ``psum_field``; a bind folds the block.  After
    ``max_sharded_rounds`` binds (tnsh's cap on sharded rounds, kept with
    its meaning) or once a block is down to one lane, the ranks gather the
    folded tables and the rest runs unsharded on the same oracle, on the
    rank's device."""

    def __init__(self, num_vars: int, terms, degree: int, mesh: Mesh,
                 max_sharded_rounds: Optional[int], blocks: bool = False):
        """``blocks``: the tables are already this rank's blocks."""
        mesh = mesh if mesh is not None else make_mesh()
        _check_world(mesh)
        lo, hi = block(mesh, 1 << num_vars)
        mine = {}

        def cut(t):
            # one slice a table, so shared tables stay shared
            got = mine.get(id(t))
            if got is None:
                if blocks:
                    got = t
                elif isinstance(t, torch.Tensor):
                    got = t[:, lo:hi]
                else:
                    got = t[lo:hi]
                mine[id(t)] = got
            return got

        super().__init__((hi - lo).bit_length() - 1,
                         [(c, [cut(t) for t in tabs]) for c, tabs in terms],
                         degree, device=mesh.device)
        self.mesh = mesh
        self.num_vars = num_vars
        self._max_sharded = max_sharded_rounds
        self._rounds = 0
        self._gathered = False

    def _sharded(self) -> bool:
        if self._gathered or self.tables.shape[-1] < 2:
            return False
        return self._max_sharded is None or self._rounds < self._max_sharded

    def _gather(self) -> None:
        if not self._gathered:
            self.tables = _gather_lanes(self.mesh, self.tables)
            self._gathered = True

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._sharded():
            return mle.unpack_fr(psum_field(
                fr_kernels.sum_of_products_round_evals(
                    self.tables, self._coeffs, self._desc, self.degree + 1),
                self.mesh))
        self._gather()
        return super().round_evaluations(round_index)

    def bind(self, challenge) -> None:
        if self.tables.shape[-1] < 2:
            self._gather()
        super().bind(challenge)
        self._rounds += 1

    def final_evaluation(self, challenges) -> Fr:
        if self.mesh.size > 1:
            self._gather()
        return super().final_evaluation(challenges)


class ShardedSumOfProductsOracle(_ShardedSop):
    """The sound-mode constraint sum-checks (degree <= 3) on the mesh.
    Proofs are bit-identical to the host oracle's in every
    configuration."""

    def __init__(self, num_vars: int, terms, mesh: Mesh = None,
                 max_sharded_rounds: Optional[int] = None):
        super().__init__(num_vars, terms, 3, mesh, max_sharded_rounds)

    @classmethod
    def from_blocks(cls, num_vars: int, terms, mesh: Mesh,
                    max_sharded_rounds: Optional[int] = None):
        """The oracle over tables that are already this rank's blocks
        (2^num_vars / ranks lanes each), in rank order."""
        o = cls.__new__(cls)
        _ShardedSop.__init__(o, num_vars, terms, 3, mesh,
                             max_sharded_rounds, blocks=True)
        return o


class ShardedSopOracleD(_ShardedSop):
    """The generic-degree sum of products (the bit-column protocols' j
    phase, degree log K + 3) on the mesh.  Proofs are bit-identical to
    the host oracle's in every configuration."""

    def __init__(self, num_vars: int, terms, degree: int, mesh: Mesh = None,
                 max_sharded_rounds: Optional[int] = None):
        super().__init__(num_vars, terms, degree, mesh, max_sharded_rounds)


class ShardedSparseCubeOracle(SumcheckOracle):
    """The sound provers' cube oracle with its cycles (the j columns)
    split over the ranks: each rank runs the k phase of
    ``SparseCubeOracle`` on its contiguous slice of T / ranks columns (on
    the native engine where it is loaded, else in Python;
    ``use_native`` picks).  A contiguous slice fixes the SLOWEST j bits,
    so a rank's tables stay its own through the k rounds and the first
    log(T / ranks) j rounds.  Each k round:

      * each rank seeds its colinc scan (and the class-I running sums)
        with the sum of the lower ranks' delta totals at the current fold
        level: an ``all_gather`` of K_rem-sized vectors;
      * the ranks' partial round evaluations meet in one ``psum_field``.

    After the k binds a rank's T / ranks-sized j tables are exactly its
    block of one mesh-wide ``ShardedSumOfProductsOracle``, so the j phase
    runs on the kernels with nothing concatenated.  Round polynomials are
    bit-identical to ``SparseCubeOracle``'s."""

    def __init__(self, log_k: int, log_t: int, terms, mesh: Mesh = None,
                 max_sharded_rounds: Optional[int] = None,
                 use_native: Optional[bool] = None):
        from ..commit.mkzg_sparse import IncrementalCubeTable, SparseCubeTable
        from ..iop.sparse_oracle import SparseCubeOracle

        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.size
        if n_dev & (n_dev - 1):
            raise SumCheckError("mesh device count must be a power of two")
        log_n = n_dev.bit_length() - 1
        if log_t <= log_n:
            raise SumCheckError(
                f"need log_t > log2(devices) ({log_t} <= {log_n})")
        self.log_k = log_k
        self.log_t = log_t
        self.num_vars = log_k + log_t
        self._max_sharded = max_sharded_rounds
        self._round = 0
        self._delegate = None
        slice_log_t = log_t - log_n
        lo, hi = block(self.mesh, 1 << log_t)
        sliced: dict = {}

        def my_slice(kind, payload):
            got = sliced.get(id(payload))
            if got is not None:
                return got
            if kind == "eqj":
                out = payload[lo:hi]
            elif kind == "eqk":
                out = payload               # k tables replicate
            elif kind == "colsparse":
                out = SparseCubeTable(log_k, slice_log_t)
                out.cols = payload.cols[lo:hi]
            elif kind == "colinc":
                out = IncrementalCubeTable(log_k, slice_log_t)
                out.updates = payload.updates[lo:hi]
            else:
                raise SumCheckError(f"unknown factor kind {kind}")
            sliced[id(payload)] = out
            return out

        my_terms = [(coeff, [(kind, my_slice(kind, payload))
                             for kind, payload in factors])
                    for coeff, factors in terms]
        self._shard = SparseCubeOracle(log_k, slice_log_t, my_terms,
                                       device=self.mesh.device,
                                       use_native=use_native)

    def _seed(self) -> None:
        """Seed the shard's colinc scan with the lower ranks' delta totals
        at the current fold level (the per-round exclusive scan)."""
        sh = self._shard
        totals = sh.inc_totals()
        if not totals:
            return
        k_rem = len(totals[0])
        mine = _ints_tensor([v for vec in totals for v in vec],
                            self.mesh.device)
        lower = _all_gather(self.mesh, mine)[:self.mesh.rank]
        if not lower:
            sh.set_colinc_start(None)
            return
        s = sum(t.to(torch.int64) & _MASK for t in lower)
        prefix = limbs.raw_ints(_renorm_mod(s, len(lower)))
        sh.set_colinc_start([prefix[i * k_rem:(i + 1) * k_rem]
                             for i in range(len(totals))])

    def round_evaluations(self, round_index: int) -> List[Fr]:
        if self._round < self.log_k:
            self._seed()
            ev = self._shard._k_round_evals()
            return [Fr(v) for v in _psum_ints(self.mesh,
                                              [int(v) for v in ev])]
        if self._delegate is None:
            self._build_delegate()
        return self._delegate.round_evaluations(round_index - self.log_k)

    def bind(self, challenge) -> None:
        if self._round < self.log_k:
            self._shard._challenges.append(challenge)
            self._shard._k_bind(challenge)
        else:
            if self._delegate is None:
                self._build_delegate()
            self._delegate.bind(challenge)
        self._round += 1

    def _build_delegate(self) -> None:
        self._seed()  # the final (K_rem = 1) colinc start scalars
        terms = self._shard._delegate_terms()
        self._shard.release()
        coeffs = _ints_tensor([c for c, _ in terms], self.mesh.device)
        for other in _all_gather(self.mesh, coeffs):
            if not torch.equal(other, coeffs):
                raise SumCheckError("shard coeff divergence")
        self._delegate = ShardedSumOfProductsOracle.from_blocks(
            self.log_t, terms, self.mesh,
            max_sharded_rounds=self._max_sharded)

    def final_evaluation(self, challenges) -> Fr:
        if self._delegate is None:
            self._build_delegate()
        return self._delegate.final_evaluation(challenges)

    def release(self) -> None:
        self._shard.release()
        if self._delegate is not None:
            self._delegate.release()


# ---------------------------------------------------------------------------
# Sharded MSM and the prover step
# ---------------------------------------------------------------------------

def sharded_msm(mesh: Mesh, points, scalars):
    """Σ s_i · P_i over every rank's block: ``points`` (a list of ``G1`` or
    a ``NativeSRS``) and ``scalars`` (``Fr`` values or 32-byte LE words)
    are this rank's block.  Its partial goes through the port's MSM router
    (``commit.kzg.msm``); the ranks' partials are all-gathered as Jacobian
    ``(8, 1)`` Fq planes and summed by ``tree_reduce_points`` (a
    power-of-two world).  Every rank returns the same ``G1``."""
    from ..commit import kzg, msm_group

    part = kzg.msm(points, scalars, mesh.device)
    coords = torch.stack([limbs.scalar(v, mesh.device, FQ_SPEC)
                          for v in (part.x, part.y, part.z)])
    X, Y, Z = (c.contiguous() for c in _gather_lanes(mesh, coords))
    return msm_group.jacobian_to_g1(*msm_group.tree_reduce_points(X, Y, Z))


def build_sharded_prover_step(mesh: Mesh):
    """The multi-rank prover step: ``step(tables, r, points, scalars)``
    runs one product round over the rank's ``(F, 8, n)`` block (the
    evaluations psummed, the tables folded at ``r``) and the sharded MSM
    over its block of points, and returns ``(evals (8, 4), folded,
    G1)``."""

    def step(tables, r, points, scalars):
        evals, folded = sharded_round_step(mesh, tables, r)
        return evals, folded, sharded_msm(mesh, points, scalars)

    return step
