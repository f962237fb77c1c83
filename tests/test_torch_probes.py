"""The train template's probe module (noise_flow_tpu_torch.probes.train_template).

Its kernels run only on the card (tests/test_torch_kernels.py holds the full
variant there); here: the module imports without CUDA and without JAX, its
site table names the 12 ``pl.pallas_call`` lines of the train-template
probes in experiments/, and the plain versions its wrappers take for CPU
tensors compute what they say.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.ops.nn import conv2d_nhwc
from noise_flow_tpu_torch.probes import train_template as tt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_FILES = ("train_attrib.py", "bn_wgrad_probe.py", "b138_launch_probe.py",
               "b138_floor_discriminate.py")


def test_probe_module_imports_without_cuda_or_jax():
    code = ("import sys, torch\n"
            "import noise_flow_tpu_torch.probes.train_template as t\n"
            "from noise_flow_tpu_torch.ops import _build\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'noise_flow_tpu.'))"
            " or m == 'noise_flow_tpu' for m in sys.modules)\n"
            "assert not _build._libs and not _build.build_logs\n"
            "print(len(t.SITES))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "12"


def test_site_table_names_every_train_template_pallas_call():
    """12 distinct sites, each on a line that holds a pl.pallas_call, and
    together every pl.pallas_call of the four probe files."""
    assert len(tt.SITES) == 12
    assert len({(s.file, s.line) for s in tt.SITES}) == 12
    assert len({s.name for s in tt.SITES}) == 12
    assert all(tt.pallas_call_lines().values())
    calls = set()
    for f in PROBE_FILES:
        with open(os.path.join(ROOT, "experiments", f)) as fh:
            calls |= {(f, i + 1) for i, line in enumerate(fh)
                      if re.search(r"\bpl\.pallas_call\(", line)}
    assert calls == {(s.file, s.line) for s in tt.SITES}


def test_wgrad_reference_is_the_conv_weight_gradient():
    """wgrad_reference: the weight gradient of a SAME 3x3 (and 1x1) conv in
    HWIO, on bfloat16-rounded operands, as autograd gives it."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((2, 32, 32, 4), generator=g)
    go = torch.randn((2, 32, 32, 4), generator=g)
    ar, gr = (ft.bf16_round(t) for t in (a, go))
    for ntaps, k in ((9, 3), (1, 1)):
        w = torch.zeros((k, k, 4, 4), requires_grad=True)
        (conv2d_nhwc(ar, w) * gr).sum().backward()
        ref = w.grad.reshape(ntaps * 16)
        got = tt.wgrad("warp", ntaps, a, go)
        np.testing.assert_allclose(got.sum(0).numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ntaps", [9, 1])
def test_wgrad_library_matmul_computes_the_reference(ntaps):
    """The library call that the probe times beside the wgrad kernel, one
    torch.matmul of wgrad_matmul_operands, is wgrad_reference's function:
    float32 sums of the same products in another order (within 1e-6
    normwise)."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn((3, 32, 32, 4), generator=g)
    go = torch.randn((3, 32, 32, 4), generator=g)
    lhs, rhs = tt.wgrad_matmul_operands(ntaps, a, go)
    assert lhs.shape == (3, ntaps * 4, 1024) and rhs.shape == (3, 1024, 4)
    got = torch.matmul(lhs, rhs).reshape(3, ntaps * 16)
    ref = tt.wgrad_reference(ntaps, a, go)
    assert float((got - ref).norm() / ref.norm()) <= 1e-6


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_bn_chain_reference_normalises_each_group(mm_dtype):
    x = 3.0 + 2.0 * torch.randn((6, 32, 32, 4), generator=torch.Generator().manual_seed(1))
    y = tt.bn_chain("production", x, 3, 2, mm_dtype)
    g = y.reshape(2, 3 * 1024, 4)
    np.testing.assert_allclose(g.mean(1).numpy(), 0.0, atol=2e-3)
    np.testing.assert_allclose(g.var(1, unbiased=False).numpy(), 1.0, atol=2e-3)
    own = tt.bn_chain("no_reduction", x, 3, 2, mm_dtype)
    np.testing.assert_allclose(own[0].reshape(-1, 4).mean(0).numpy(), 0.0, atol=2e-3)


def test_ablated_variants_have_no_plain_version():
    x = torch.zeros((2, 32, 32, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tt.segment_backward(tt.PROD, "no_wgrad", x, None, None, None, [], 2, x, x[:, 0, 0, 0])
    with pytest.raises(ValueError, match="CUDA"):
        tt.segment_train_forward(tt.PARENT, "no_bn_stats", x, None, None, None, [], 2)
    with pytest.raises(ValueError, match="CUDA"):
        tt.launch("noop", 0, x, x, None, None, None, None, None, [], 2, x)


def test_every_probe_library_has_its_source_and_counter():
    """Each library of the probe module builds from a source in csrc/, each
    site names the launch counters its wrappers add to, and no counter is
    named twice."""
    from noise_flow_tpu_torch.ops import _build

    names = ["train_probe", *_build.VARIANT_LIBRARIES]
    assert set(names) <= set(_build.SIGNATURES)
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in names)
    counters = [c for s in tt.SITES for c in s.counters]
    assert len(counters) == len(set(counters)) == 13
    with open(tt.__file__) as fh:
        text = fh.read()
    variants = {f"train_probe_{v}" for v in tt.LAUNCH_VARIANTS + tt.FLOOR_VARIANTS}
    assert variants <= set(counters)
    assert all(f'_launch("{c}"' in text for c in set(counters) - variants)


def test_ablation_codes_are_the_kernel_template_enum():
    """The ablations' codes are the values of enum Ablation in
    csrc/train_kernel.cuh, and an unknown design is refused by name."""
    from noise_flow_tpu_torch.ops import _build

    with open(_build.CSRC / "train_kernel.cuh") as fh:
        enum = dict(re.findall(r"^\s+(ABL_\w+) = (\d+),", fh.read(), re.M))
    names = {"full": "ABL_FULL", "no_wgrad": "ABL_NO_WGRAD", "bn_diag": "ABL_BN_DIAG",
             "no_epilogue": "ABL_NO_EPI", "forward_only": "ABL_FWD_ONLY",
             "no_bn_stats": "ABL_NO_BN_STATS"}
    for table in (tt.BWD_ABLATIONS, tt.FWD_ABLATIONS):
        assert all(int(enum[names[k]]) == v for k, v in table.items())
    with pytest.raises(ValueError, match="design"):
        tt._vlib("fastest", "float32")
