"""The port's recipes (noise_flow_tpu_torch/jobs/*.sh) against the JAX
package's (jobs/*.sh): both scripts of each pair parsed, the same recipe
names, and in each recipe the same commands with the same flags, where the
port runs ``python -m noise_flow_tpu_torch.cli.*`` in place of the JAX
package's entry points and writes under experiments/sidd_torch/ where JAX
writes experiments/sidd/. Every port command's flags parse with its CLI's
own argument parser."""

import argparse
import importlib
import os
import re
import shlex

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = ["job_noise_flow.sh", "job_dncnn.sh"]
# the JAX package's entry points -> the port's modules
PROGRAMS = {
    "train_noise_flow.py": "noise_flow_tpu_torch.cli.train",
    "train_dncnn_noiseflow.py": "noise_flow_tpu_torch.cli.train_dncnn",
    "test_dncnn_noiseflow.py": "noise_flow_tpu_torch.cli.test_dncnn",
    "noise_flow_tpu.cli.kld_sweep": "noise_flow_tpu_torch.cli.kld_sweep",
    "experiments/sidd/make_sidd_scale.py": "noise_flow_tpu_torch.cli.make_sidd_scale",
}
# the scripts' shell variables, at their defaults, for the parsers
SHELL = {"$NPROC": "2", "$PID": "0", "$COORD": "host0:8476",
         "$SIDD": "./data/SIDD_Medium_Raw/Data", "$NF_DIR": "experiments/sidd_torch/published"}


def _recipes(path):
    """{recipe name: [(program, [arguments])]} of a ``case "$cfg"`` script."""
    text = open(path).read().replace("\\\n", " ")
    body = text[text.index('case "$cfg" in'):text.index("esac")]
    out = {}
    for m in re.finditer(r"^  ([a-z0-9-]+)\)(.*?);;", body, re.S | re.M):
        cmds = []
        for line in m.group(2).splitlines():
            line = line.split("#", 1)[0].strip()
            if not line.startswith("python"):
                continue
            words = shlex.split(line)[1:]
            prog, args = (words[1], words[2:]) if words[0] == "-m" else (words[0], words[1:])
            cmds.append((prog, args))
        out[m.group(1)] = cmds
    return out


def _flags(args):
    """[(flag, value or None)] in order."""
    out, i = [], 0
    while i < len(args):
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            out.append((args[i], args[i + 1]))
            i += 2
        else:
            out.append((args[i], None))
            i += 1
    return out


class _Parsed(Exception):
    pass


def _check_parses(module, args):
    """Run the port CLI's main up to its argument parsing; raise on any
    argument its parser does not know."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, argv=None, namespace=None):
        _, unknown = self.parse_known_args(argv, namespace)
        assert not unknown, (module, unknown)
        raise _Parsed
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(_Parsed):
            importlib.import_module(module).main(list(args))
    finally:
        argparse.ArgumentParser.parse_args = real


@pytest.mark.parametrize("script", PAIRS)
def test_port_recipes_are_the_jax_recipes(script):
    jax = _recipes(os.path.join(REPO, "jobs", script))
    port = _recipes(os.path.join(REPO, "noise_flow_tpu_torch", "jobs", script))
    assert jax and set(port) == set(jax)   # the port takes every recipe
    for name, cmds in jax.items():
        assert len(port[name]) == len(cmds), name
        for (jprog, jargs), (pprog, pargs) in zip(cmds, port[name]):
            assert pprog == PROGRAMS[jprog], (name, jprog, pprog)
            want = [(f, None if v is None else v.replace("experiments/sidd/",
                                                          "experiments/sidd_torch/"))
                    for f, v in _flags(jargs)]
            assert _flags(pargs) == want, name
            _check_parses(pprog, [SHELL.get(a, a) for a in pargs])


def test_port_recipes_run_as_scripts():
    """Both are executable bash scripts that refuse an unknown recipe."""
    import subprocess

    for script in PAIRS:
        path = os.path.join(REPO, "noise_flow_tpu_torch", "jobs", script)
        assert os.access(path, os.X_OK)
        r = subprocess.run(["bash", path, "no-such-recipe"], capture_output=True, text=True,
                           cwd=REPO)
        assert r.returncode == 1 and "unknown config" in r.stderr
