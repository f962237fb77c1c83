"""The sampler group's probe module (noise_flow_tpu_torch.probes.sampler).

Its kernels run only on the card (tests/test_torch_kernels.py holds them
there). Here: the module imports without CUDA and without JAX; its site
table names the 3 ``pl.pallas_call`` lines of experiments/kernel_probe.py,
kernel_sweep.py and mxu_bound_probe.py, read as text (kernel_probe.py runs
its benchmark when imported, and the TPU probes draw their input with the
TPU's PRNG, which the Pallas interpreter lacks, so none of them runs here);
the plain versions its wrappers take for CPU tensors compute what the TPU
probes' own lines define, on the flagship architecture; the variant codes
are the C template's.
"""

import copy
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.ops import pallas_sample as ps
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.probes import sampler as sp
from noise_flow_tpu_torch.utils.checkpoint import from_numpy_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_FILES = ("kernel_probe.py", "kernel_sweep.py", "mxu_bound_probe.py")
FLAGSHIP = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
B, TEMP = 2, 0.6


def test_probe_module_imports_without_cuda_or_jax():
    code = ("import sys, torch\n"
            "import noise_flow_tpu_torch.probes.sampler as s\n"
            "from noise_flow_tpu_torch.ops import _build\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'noise_flow_tpu.'))"
            " or m == 'noise_flow_tpu' for m in sys.modules)\n"
            "assert not _build._libs and not _build.build_logs\n"
            "print(len(s.SITES))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"


def test_site_table_names_every_sampler_pallas_call():
    """3 distinct sites, each on a line that holds a pl.pallas_call, and
    together every pl.pallas_call of the three probe files."""
    assert len({(s.file, s.line) for s in sp.SITES}) == len({s.name for s in sp.SITES}) == 3
    assert all(sp.pallas_call_lines().values())
    calls = set()
    for f in PROBE_FILES:
        with open(os.path.join(ROOT, "experiments", f)) as fh:
            calls |= {(f, i + 1) for i, line in enumerate(fh)
                      if re.search(r"\bpl\.pallas_call\(", line)}
    assert calls == {(s.file, s.line) for s in sp.SITES}


@pytest.fixture(scope="module")
def flagship():
    """The flagship architecture at the TPU probes' seed-0 init, perturbed
    (so that the zero-convs and BN statistics are not trivial, as
    tests/test_torch_sample.py does), in both packages; the JAX program in
    kernel_probe.py's fold (version 1) and the port's, running BN; one
    input of B patches."""
    jflow = JaxFlow((32, 32, 4), jax_default_config(arch=FLAGSHIP, patch_height=32))
    params, state = jflow.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(1), x.shape), params)
    state = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jnp.abs(jax.random.normal(jax.random.PRNGKey(2), x.shape)), state)
    flow = NoiseFlow((32, 32, 4), default_config(arch=FLAGSHIP, patch_height=32), device="cpu")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    flow.load_state_dict(from_numpy_tree(to_np(params), to_np(state)))
    rng = np.random.default_rng(0)
    cond = {"clean": rng.uniform(0.01, 0.9, (B, 32, 32, 4)).astype(np.float32),
            "nlf0": np.full(B, 0.000479, np.float32), "nlf1": np.full(B, 2e-6, np.float32),
            "iso": np.full(B, 100.0, np.float32), "cam": np.full(B, 2.0, np.float32)}
    x = (rng.standard_normal((B, 32, 32, 4)) * TEMP).astype(np.float32)
    jprog = ps.build_sample_program(jflow, params, state, version=1)
    prog = fs.build_sample_program(flow, bn_mode="running")
    jsa, jsb = jprog.scale_ab({k: jnp.asarray(v) for k, v in cond.items()}, B)
    sa, sb = prog.scale_ab({k: torch.as_tensor(v) for k, v in cond.items()}, B)
    return {"jprog": jprog, "prog": prog, "x": x, "clean": cond["clean"], "jsa": jsa,
            "jsb": jsb, "sa": sa, "sb": sb}


def _tpu_probe_chain(prog, x, clean, sa, sb, variant):
    """kernel_probe.py's make_kernel body (:40-105) in plain jnp, one block
    of the whole batch, float32 at HIGHEST precision, on a given x instead
    of the TPU's PRNG draw: the TPU definition of each variant."""
    notrans, noshift, nocoupnn = (variant == v for v in ("notrans", "noshift", "nocoupnn"))
    H, WC, C = ps.H, ps.WC, ps.C
    bt = x.shape[0]

    def mm(x2, m):
        return jnp.dot(x2, m, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)

    def shift(x, dh):
        return x if noshift else ps._shift_h(x, dh)

    def tanh(u):
        return u * 0.9 if notrans else jnp.tanh(u)

    def exp(u):
        return 1.0 + u if notrans else jnp.exp(u)

    lane = jnp.arange(WC).reshape(1, 1, WC)
    keep_mask = (lane % C) < (C // 2)
    for op in prog.ops:
        kind, idx = op[0], op[1]
        if kind == "mix":
            x = mm(x.reshape(bt * H, WC), prog.mixes[idx]).reshape(bt, H, WC)
        elif kind == "scale":
            x = x * jnp.sqrt(sa[:, idx].reshape(bt, 1, 1) * clean + sb[:, idx].reshape(bt, 1, 1))
        elif not nocoupnn:
            h = mm(x.reshape(bt * H, WC), prog.m1s[idx, 1])
            h = h + mm(shift(x, -1).reshape(bt * H, WC), prog.m1s[idx, 0])
            h = h + mm(shift(x, 1).reshape(bt * H, WC), prog.m1s[idx, 2])
            h = jax.nn.relu(h + prog.b1s[idx].reshape(1, WC))
            h = jax.nn.relu(mm(h, prog.m2s[idx]) + prog.b2s[idx].reshape(1, WC))
            h3 = h.reshape(bt, H, WC)
            t = mm(h, prog.m3s[idx, 1])
            t = t + mm(shift(h3, -1).reshape(bt * H, WC), prog.m3s[idx, 0])
            t = t + mm(shift(h3, 1).reshape(bt * H, WC), prog.m3s[idx, 2])
            t = t.reshape(bt, H, 2 * WC) + prog.offs[idx].reshape(1, H, 2 * WC)
            ls = prog.rescales[idx] * tanh(t[..., WC:])
            x = jnp.where(keep_mask, x, (x - t[..., :WC]) * exp(-ls))
    return np.asarray(x).reshape(bt, H, 32, C)


@pytest.mark.parametrize("variant", ["full", "notrans", "nocoupnn"])
def test_ablation_plain_versions_are_the_tpu_definitions(flagship, variant):
    """The plain version of each ablation against kernel_probe.py's own
    definition (:45-56, :82-83) in JAX, on the same input: base, tanh u ->
    0.9 u with exp u -> 1 + u, couplings skipped. A planted variant (tanh u
    -> u for notrans, the couplings kept for nocoupnn, the taps dropped for
    base) must fail the same tolerance."""
    f = flagship
    ref = _tpu_probe_chain(f["jprog"], jnp.asarray(f["x"]).reshape(B, 32, 128),
                           jnp.asarray(f["clean"]).reshape(B, 32, 128), f["jsa"], f["jsb"],
                           "base" if variant == "full" else variant)
    x, clean = torch.as_tensor(f["x"]), torch.as_tensor(f["clean"])
    got = sp.sample_variant(f["prog"], variant, x, clean, f["sa"], f["sb"]).numpy()
    # float32 sums in another order (banded 128-lane products against 3x3
    # taps): observed at most 1.9e-6 abs on values up to 7.9
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, **tol)
    wrong = (sp.ablated_chain_reference(f["prog"], x, clean, f["sa"], f["sb"], None, "float32",
                                        "notrans", slope=1.0) if variant == "notrans"
             else sp.variant_reference(f["prog"], "noshift" if variant == "full" else "full",
                                       x, clean, f["sa"], f["sb"]))
    assert not np.allclose(wrong.numpy(), ref, **tol)


def _centre_tap_program(prog):
    """prog with every 3x3 kernel summed into its centre tap and the
    indicator weights zero: where every tap reads the centre pixel, the
    chain of the noshift ablation."""
    coup = prog.coup.clone()
    for name in ("w1", "w3"):
        off, shape = fs._REC_LAYOUT[name]
        w = coup[:, off:off + int(np.prod(shape))].reshape(-1, *shape)
        centre = torch.zeros_like(w)
        centre[:, 1, 1] = w.sum((1, 2))
        coup[:, off:off + int(np.prod(shape))] = centre.reshape(coup.shape[0], -1)
    off, shape = fs._REC_LAYOUT["wind"]
    coup[:, off:off + int(np.prod(shape))] = 0.0
    out = copy.copy(prog)
    out.coup = coup
    return out


@pytest.mark.parametrize("bn_mode", ["running", "batch"])
def test_noshift_plain_version_reads_the_centre_pixel(flagship, bn_mode):
    """kernel_probe.py:45-48 drops the row shifts (``shift(x, dh)`` returns
    x); on the card the column taps are shifts too (neighbour reads from
    shared memory with a border branch and indicator taps), so noshift drops
    both: the plain version equals the full chain of a program whose 3x3
    kernels are summed into their centre tap with no indicator weights, and
    differs from the full chain."""
    f = flagship
    prog = f["prog"]
    if bn_mode == "batch":
        prog = copy.copy(prog)
        prog.bn_mode = "batch"
    x, clean = torch.as_tensor(f["x"]), torch.as_tensor(f["clean"])
    for dt in ("float32", "bfloat16"):
        got = sp.variant_reference(prog, "noshift", x, clean, f["sa"], f["sb"], B, dt)
        if dt == "float32":
            ref = fs.sample_chain_reference(_centre_tap_program(prog), x, clean, f["sa"],
                                            f["sb"], B)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
        full = sp.variant_reference(prog, "full", x, clean, f["sa"], f["sb"], B, dt)
        assert float((got - full).abs().max()) > 1e-4


@pytest.mark.parametrize("variant", ["ppt2", "ppt8", "interleave", "concat_k",
                                     "concat_k_interleave", "precast",
                                     "concat_k_interleave_precast"])
def test_design_plain_versions_are_the_sampler(flagship, variant):
    """The designs compute the sampler's function: their plain version is
    sample_chain_reference, bit for bit, in both BN modes and precisions;
    the bfloat16-only designs refuse float32."""
    f = flagship
    x, clean = torch.as_tensor(f["x"]), torch.as_tensor(f["clean"])
    for dt in ("float32", "bfloat16"):
        if variant in sp.BF16_ONLY and dt == "float32":
            with pytest.raises(ValueError, match="bfloat16"):
                sp.sample_variant(f["prog"], variant, x, clean, f["sa"], f["sb"], None, dt)
            continue
        got = sp.sample_variant(f["prog"], variant, x, clean, f["sa"], f["sb"], None, dt)
        ref = fs.sample_chain_reference(f["prog"], x, clean, f["sa"], f["sb"], None, dt)
        assert torch.equal(got, ref)
    seeded = sp.sample_variant(f["prog"], variant, None, clean, f["sa"], f["sb"], None,
                               "bfloat16", seed=5, temp=TEMP)
    ref = fs.sample_chain_reference(f["prog"], fs.rng_normals_reference(5, B) * TEMP, clean,
                                    f["sa"], f["sb"], None, "bfloat16")
    assert torch.equal(seeded, ref)


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_chain_plain_version_is_the_jax_dot_chain(mm_dtype):
    """mm_chain_reference against mxu_bound_probe.py's chain (:76-81):
    ``jax.lax.dot(x.astype(dt), w[i].astype(dt), preferred_element_type=
    float32)``, 56 products, on seeded normals with w ~ N(0, 1/128); the
    CPU wrappers (mm_chain, px_chain) are the plain version; one product
    skipped fails."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = (rng.standard_normal((sp.N_MM, 128, 128)) / np.sqrt(128)).astype(np.float32)
    dt = jnp.bfloat16 if mm_dtype == "bfloat16" else jnp.float32
    ref = jnp.asarray(x)
    for i in range(sp.N_MM):
        ref = jax.lax.dot(ref.astype(dt), jnp.asarray(w[i]).astype(dt),
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(ref)
    got = sp.mm_chain(torch.as_tensor(x), torch.as_tensor(w), mm_dtype).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= sp.CHAIN_RTOL[mm_dtype], rel
    skipped = sp.mm_chain_reference(torch.as_tensor(x), torch.as_tensor(w[1:]), mm_dtype).numpy()
    assert np.linalg.norm(skipped - ref) / np.linalg.norm(ref) > 0.1
    xp = torch.as_tensor(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    wp = sp.random_rotations(sp.N_MM, 4, torch.Generator().manual_seed(0))
    assert torch.allclose(torch.linalg.matrix_norm(wp[0]), torch.tensor(2.0))
    for v in (["f32"] if mm_dtype == "float32" else ["bf16_fma", "bf16_mma"]):
        assert torch.equal(sp.px_chain(v, xp, wp), sp.mm_chain_reference(xp, wp, mm_dtype))
    with pytest.raises(ValueError, match="chain variant"):
        sp.px_chain("tf32", xp, wp)


def test_chain_prefix_tolerance_catches_a_chain_without_rerounding():
    """Over its first CHAIN_PREFIX products the bfloat16 chain of another
    summation order (mxu_bound_probe.py's jax.lax.dot chain, :76-81) stays
    within CHAIN_PREFIX_RTOL of the plain version, and a chain that does not
    round its intermediates again (chain_without_rerounding) does not."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2048, 128)).astype(np.float32)
    w = (rng.standard_normal((sp.CHAIN_PREFIX, 128, 128)) / np.sqrt(128)).astype(np.float32)
    ref = sp.mm_chain_reference(torch.as_tensor(x), torch.as_tensor(w), "bfloat16").numpy()
    jx = jnp.asarray(x)
    for i in range(sp.CHAIN_PREFIX):
        jx = jax.lax.dot(jx.astype(jnp.bfloat16), jnp.asarray(w[i]).astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
    unrounded = sp.chain_without_rerounding(torch.as_tensor(x), torch.as_tensor(w)).numpy()

    def rel(a):
        return np.linalg.norm(np.asarray(a) - ref) / np.linalg.norm(ref)
    assert rel(jx) <= sp.CHAIN_PREFIX_RTOL["bfloat16"], rel(jx)
    assert rel(unrounded) > sp.CHAIN_PREFIX_RTOL["bfloat16"], rel(unrounded)


def test_variant_codes_are_the_kernel_template():
    """ABLATIONS are the values of enum Ablation in csrc/sample_kernel.cuh,
    DESIGN_BITS its DESIGN_* constants, the chain variants enum PxVariant of
    csrc/sample_probe.cu; every variant of VARIANTS is instantiated by
    csrc/sample_variants.cuh in its precisions, and nothing else is."""
    from noise_flow_tpu_torch.ops import _build

    text = (_build.CSRC / "sample_kernel.cuh").read_text()
    enum = dict(re.findall(r"^\s+(ABL_\w+) = (\d+),", text, re.M))
    assert {k: int(enum[f"ABL_{k.upper()}"]) for k in sp.ABLATIONS} == sp.ABLATIONS
    bits = dict(re.findall(r"constexpr int DESIGN_(\w+) = (\d+);", text))
    assert {k: int(bits[k.upper()]) for k in sp.DESIGN_BITS} == sp.DESIGN_BITS
    px = dict(re.findall(r"(PX_\w+) = (\d+)", (_build.CSRC / "sample_probe.cu").read_text()))
    assert {k: int(px[f"PX_{k.upper()}"]) for k in sp.PX_VARIANTS} == sp.PX_VARIANTS
    inst = (_build.CSRC / "sample_variants.cuh").read_text()
    common, bf16 = inst.split("#if VARIANT_BF")
    names = {"DESIGN_PARENT": 0, **{f"DESIGN_{k.upper()}": v for k, v in sp.DESIGN_BITS.items()}}

    def instantiated(part):
        out = set()
        for a, d, p in re.findall(r"SAMPLE_VARIANT\((ABL_\w+), ([\w |]+), (\d)\)", part):
            out.add((int(enum[a]), sum(names[n.strip()] for n in d.split("|")), int(p)))
        return out
    want = {n: (sp.ABLATIONS[a], sum(sp.DESIGN_BITS[d] for d in ds), p)
            for n, (a, ds, p) in sp.VARIANTS.items()}
    assert instantiated(common) == {v for n, v in want.items() if n not in sp.BF16_ONLY}
    assert instantiated(bf16) == {want[n] for n in sp.BF16_ONLY}


def test_every_sampler_probe_library_has_its_source_and_counter():
    """Each library of the module builds from a source in csrc/ with a ctypes
    signature; each site names a counter its wrappers add to, and no counter
    is named twice."""
    from noise_flow_tpu_torch.ops import _build

    names = ["sample_probe", *_build.SAMPLE_VARIANT_LIBRARIES]
    assert set(names) <= set(_build.SIGNATURES)
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in names)
    counters = [c for s in sp.SITES for c in s.counters]
    assert len(counters) == len(set(counters)) == 3
    with open(sp.__file__) as fh:
        text = fh.read()
    assert all(f'"{c}"' in text for c in counters)
    with pytest.raises(ValueError, match="unknown sampler variant"):
        sp.variant_reference(None, "fastest", None, None, None, None)
