"""Whole runs of each cell on the CPU at small sizes (the harness's look for
a card skipped), with the timed path broken underneath by each fault that
the cell's traffic kind can have (``FAULTS`` of ``harness/<kind>.py``):
``correct`` comes out false. The port's kernels take their plain PyTorch
versions on the CPU; the comparison and its limits are the cell's own."""

import argparse

import pytest

import run
from harness import spec

CELLS = {w["name"]: spec.driver(spec.cell(w["name"])["traffic"]["kind"])
         for w in spec.benchmark()["workloads"]}


def _small(plant=None):
    def adjust(cell, ctx):
        CELLS[ctx.workload["name"]].shrink(ctx)
        ctx.seconds = 0.3
        ctx.plant = plant
    return adjust


def _run(name, plant=None, seed=2 ** 31 + 77):
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=0)
    return run.run_cell(name, args, device="cpu", adjust=_small(plant))


@pytest.mark.parametrize("name,fault", [(n, f) for n, k in sorted(CELLS.items())
                                        for f in sorted(k.FAULTS)])
def test_a_planted_fault_is_not_correct(name, fault):
    res = _run(name, CELLS[name].FAULTS[fault])
    assert res["correct"] is False, res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_result_line_has_the_contract_keys(name):
    res = _run(name)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec.cell(name)["end_to_end"]}
    assert all(c["limit"] is not None for c in res["checks"].values())
