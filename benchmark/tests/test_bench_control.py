"""The precision control: the plain reference put in the program's place
and computed in float32 with TF32 products (the nearest precision below the
configurations' float32 with TF32 off) comes out not correct under each
cell's limits. On the CPU at the cells' batch with TF32 emulated by operand
rounding (three train steps; a few sampler patches); on the card at the
cells' own size, over three seeds, with the program's own runs correct."""


import pytest
import torch

import run
from harness import check, spec, synth
from reference.flow import RefFlow, tf32_round

TRAIN = sorted(w["name"] for w in spec.benchmark()["workloads"]
               if spec.cell(w["name"])["traffic"]["kind"] == "train")
SAMPLE = sorted(w["name"] for w in spec.benchmark()["workloads"]
                if spec.cell(w["name"])["traffic"]["kind"] == "sample")


def _config(name):
    cell = spec.cell(name)
    return cell, dict(cell["config"], weights_path=str(run.ROOT / cell["config"]["weights"]))


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails_on_cpu(name):
    cell, config = _config(name)
    b, steps = config["n_batch_train"], 3
    rows = synth.parse_rows(cell["traffic"]["nlf_rows"])
    data = synth.make_split(b * steps, rows, cell["traffic"]["clean"], 5, "cpu")
    marks = {"eager": 1, "end": steps - 1}
    ref = check.reference_run(config, data, steps, marks, "cpu")
    ctl = check.reference_run(config, data, steps, marks, "cpu", torch.float32, tf32_round)
    numbers = check.train_numbers(ctl, ref)
    correct, checks = check.verdict(numbers, cell["limits"]["limits"])
    assert not correct, checks


@pytest.mark.parametrize("name", SAMPLE)
def test_sample_control_fails_on_cpu(name):
    cell, config = _config(name)
    temp = cell["traffic"]["temp"]
    gen = torch.Generator().manual_seed(5)
    rows = synth.parse_rows(cell["traffic"]["nlf_rows"])
    conds = [synth.make_cond(32, row, cell["traffic"]["clean"], gen, "cpu") for row in rows[:3]]
    ctl_ref = RefFlow(config["weights_path"], config["arch"], config["width"], torch.float32,
                      "cpu", tf32_round)
    answers = [(1000 + i, i, check.reference_noise(ctl_ref, 1000 + i, conds[i], temp))
               for i in range(3)]
    gap = check.sample_gap(config, answers, conds, temp, "cpu")
    correct, checks = check.verdict({"sample_gap": gap}, cell["limits"]["limits"])
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + SAMPLE)
def test_control_fails_and_program_passes_on_card(name, cuda_device):
    import calibrate

    seeds = "3100000001,3100000002,3100000003"
    res = calibrate.run_readings(name, seeds, seeds, seconds=2.0, device=str(cuda_device))
    limits = spec.cell(name)["limits"]["limits"]
    for seed, numbers in res["program"].items():
        assert check.verdict(numbers, limits)[0], (seed, numbers)
    for seed, numbers in res["control"].items():
        assert not check.verdict(numbers, limits)[0], (seed, numbers)
