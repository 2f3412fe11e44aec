"""The generator reproduces the traffic it copies: chip_smoke's
bench_trace (random.seed(5)) and bench_lookups (random.Random(11))."""

import pytest

from proofbench import generate


@pytest.mark.parametrize("seed", [5, 11])
def test_memory_matches_bench_trace(seed):
    import chip_smoke

    inp = generate.make_inputs(
        {"kind": "memory", "log_t": 12, "inputs": 1, "write_every": 3,
         "value_step": 42}, {"log_k": 10}, seed)[0]
    tr = chip_smoke.bench_trace(10, 12)
    ops = [(op.is_write, op.address, int(op.value) if op.is_write else 0)
           for op in tr.operations]
    mine = list(zip(map(bool, inp.is_write), inp.addr, inp.value))
    assert (mine == ops) == (seed == 5)


@pytest.mark.parametrize("seed", [5, 11])
def test_lookup_matches_bench_lookups(seed):
    import chip_smoke

    inp = generate.make_inputs(
        {"kind": "lookup", "log_t": 12, "inputs": 1, "entry_step": 3,
         "entry_offset": 1, "lookups_short": 1}, {"log_k": 10}, seed)[0]
    tbl = chip_smoke.bench_lookups(10, 12)
    assert inp.entries == [int(e) for e in tbl.entries]
    assert (list(inp.index) == [op.index for op in tbl.lookups]) == (
        seed == 11)


def test_inputs_differ_and_repeat():
    traffic = {"kind": "memory", "log_t": 8, "inputs": 3, "write_every": 3,
               "value_step": 42}
    a = generate.make_inputs(traffic, {"log_k": 4}, 2 ** 31 + 7)
    b = generate.make_inputs(traffic, {"log_k": 4}, 2 ** 31 + 7)
    assert [x.addr for x in a] == [x.addr for x in b]
    assert len({bytes(x.addr) for x in a}) == 3
