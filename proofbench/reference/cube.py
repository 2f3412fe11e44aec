"""The tables of TwistBits' phase A over the dense (k, j) cube, straight
from the statement: the plain reference the CPU tests hold the port's
dense stack against.  It does not decide ``correct``; ``twist_bits.judge``
does, from the proof's bytes.

Written in Python ints alone.  It imports nothing of the program under
test, of the JAX package or of jax.

Over K = 2^log_k cells and T = 2^log_t cycles a table holds K T values,
lane j K + k: k is the fastest index, so the sum-check's first log K
variables are k's bits (variable 0 the fastest, as in ``pst``).  From a
memory trace (a write flag, an address and a value a cycle) and phase A's
challenges rho1 and rhob (log T each) and sigma (log K + log T, k's first)
the 9 + 4 log K tables are, in this order:

  eq1(j); 1 - ot(j); chi(k_i, rb_i(j)) for each bit i; V(k, j); rv(j);
  eq(sigma_k, k) eq(sigma_j, j); ot(j); chi(k_i, wb_i(j)) for each i;
  ic(j); wv(j); eqb(j); rb_i(j) for each i; wb_i(j) for each i

where a table of j alone is lifted over k (the same value at every k),
eq(r, x) = prod_i (r_i x_i + (1 - r_i)(1 - x_i)), chi(x, b) = x b +
(1 - x)(1 - b), and V(k, j) is the value last written to cell k before
cycle j (0 where none was).  ot is 1 on a write cycle; rv is the value the
read cycle's cell holds, wv the value written and ic the written value
less the one held.

Where this departs from the statement as the paper writes it, it follows
the bit-column tier's committed columns, whose cycles read or write, not
both: rb_i is 0 on a write cycle and wb_i, wv and ic are 0 on a read
cycle (the terms that use them carry 1 - ot or ot, so the sum is the
same); rv is 0 on a write cycle; cycles past the trace, up to the next
power of two, read cell 0.
"""

from __future__ import annotations

from typing import List, Sequence

from .curve import P
from .pst import chi, eq_table


def columns(log_k: int, log_t: int, is_write: Sequence[int],
            addr: Sequence[int], value: Sequence[int]) -> dict:
    """The committed columns of a trace of at most 2^log_t cycles:
    ``rb`` and ``wb`` (log K bit columns each), ``ot``, ``rv``, ``wv``,
    ``ic``, each of T values."""
    t_size = 1 << log_t
    rb = [[0] * t_size for _ in range(log_k)]
    wb = [[0] * t_size for _ in range(log_k)]
    ot, rv, wv, ic = ([0] * t_size for _ in range(4))
    mem = [0] * (1 << log_k)
    for j in range(t_size):
        w, a, v = ((is_write[j], addr[j], value[j]) if j < len(addr)
                   else (0, 0, 0))
        bits = wb if w else rb
        for i in range(log_k):
            bits[i][j] = a >> i & 1
        if w:
            v %= P
            ot[j], wv[j], ic[j] = 1, v, (v - mem[a]) % P
            mem[a] = v
        else:
            rv[j] = mem[a]
    return {"rb": rb, "wb": wb, "ot": ot, "rv": rv, "wv": wv, "ic": ic}


def last_written(log_k: int, cols: dict) -> List[List[int]]:
    """V: for each cycle j, the value each cell holds before j."""
    held = [0] * (1 << log_k)
    out = []
    for j, w in enumerate(cols["ot"]):
        out.append(list(held))
        if w:
            held[sum(cols["wb"][i][j] << i for i in range(log_k))] = \
                cols["wv"][j]
    return out


def twist_tables(log_k: int, log_t: int, is_write: Sequence[int],
                 addr: Sequence[int], value: Sequence[int],
                 rho1: Sequence[int], rhob: Sequence[int],
                 sigma: Sequence[int]) -> List[List[int]]:
    """The 9 + 4 log K cube tables of the module's list, lane j K + k."""
    k_size, t_size = 1 << log_k, 1 << log_t
    cols = columns(log_k, log_t, is_write, addr, value)
    rb, wb, ot = cols["rb"], cols["wb"], cols["ot"]
    eq1, eqb = eq_table(rho1), eq_table(rhob)
    eq_k, eq_j = eq_table(sigma[:log_k]), eq_table(sigma[log_k:])
    held = last_written(log_k, cols)

    def cube(f) -> List[int]:
        return [f(k, j) % P for j in range(t_size) for k in range(k_size)]

    def over_k(col) -> List[int]:
        return cube(lambda k, j: col[j])

    def chis(bit_cols) -> List[List[int]]:
        return [cube(lambda k, j, i=i, b=b: chi(k >> i & 1, b[j]))
                for i, b in enumerate(bit_cols)]

    return ([over_k(eq1), over_k([1 - o for o in ot])]
            + chis(rb)
            + [cube(lambda k, j: held[j][k]), over_k(cols["rv"]),
               cube(lambda k, j: eq_k[k] * eq_j[j]), over_k(ot)]
            + chis(wb)
            + [over_k(cols["ic"]), over_k(cols["wv"]), over_k(eqb)]
            + [over_k(b) for b in rb + wb])
