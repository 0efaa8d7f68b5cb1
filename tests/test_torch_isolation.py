"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_every_submodule_imports_without_jax():
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in "
        "sys.modules.items() if v is not None)\n"
        "print(len(" + repr(names) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(names) >= 68


def test_nothing_builds_at_import():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    from repro_torch.kernels import build
    assert build._libs == {}


@pytest.mark.parametrize("module", ["models/ssm.py", "models/rwkv.py",
                                    "configs/zamba2_1_2b.py",
                                    "configs/rwkv6_1_6b.py"])
def test_recurrent_modules_are_checked(module):
    """The recurrent families' modules are among the files checked above
    and import only torch, numpy, the standard library and the port."""
    path = PORT / module
    assert path in _port_files()
    allowed = {"torch", "numpy", "repro_torch", "__future__", "typing",
               "dataclasses"}
    assert {m.split(".")[0] for m in _imports(path)} <= allowed, path


TRAINING_MODULES = ["optim/optimizers.py", "ckpt/checkpoint.py",
                    "dist/fault.py", "launch/train.py", "launch/export.py",
                    "launch/steps.py", "core/calibrate.py", "core/anneal.py",
                    "core/bitflip.py"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_checked(module):
    """The training slice's modules (the optimizer, checkpoints, the step
    monitor, the trainer, the exporter, the steps, calibration, annealing,
    the bit-flip simulators) are among the files and submodules checked
    above and import only torch, numpy, the standard library and the
    port."""
    path = PORT / module
    assert path in _port_files()
    name = "repro_torch." + module[:-3].replace("/", ".")
    assert name in [m.name for m in pkgutil.walk_packages(
        [str(PORT)], "repro_torch.")]
    std = {"__future__", "argparse", "contextlib", "dataclasses", "json",
           "math", "os", "shutil", "tempfile", "time", "types", "typing",
           "zipfile", "functools", "struct"}
    allowed = {"torch", "numpy", "repro_torch"} | std
    assert {m.split(".")[0] for m in _imports(path)} <= allowed, path


FLEET_MODULES = ["serve_engine/fleet.py", "dist/sharding.py",
                 "dist/fault.py", "kernels/autotune.py"]


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_and_autotune_modules_are_checked(module):
    """The fleet's modules (the fleet, the rung sharding, the host
    supervisor) and the autotuner are among the files and submodules
    checked above and import only torch, numpy, the standard library and
    the port."""
    path = PORT / module
    assert path in _port_files()
    name = "repro_torch." + module[:-3].replace("/", ".")
    assert name in [m.name for m in pkgutil.walk_packages(
        [str(PORT)], "repro_torch.")]
    std = {"__future__", "dataclasses", "functools", "json", "os",
           "tempfile", "time", "typing"}
    allowed = {"torch", "numpy", "repro_torch"} | std
    assert {m.split(".")[0] for m in _imports(path)} <= allowed, path



DIST_MODULES = ["dist/compat.py", "dist/constrain.py", "dist/sharding.py",
                "dist/local_ops.py", "dist/collectives.py",
                "dist/pipeline.py", "dist/moe_ep.py", "launch/mesh.py"]


@pytest.mark.parametrize("module", DIST_MODULES)
def test_dist_modules_are_checked(module):
    """``dist/`` on torch.distributed (the version shim and the host-staged
    group, the constraints, the specs and placements, the local forms,
    the compressed all-reduce, the pipeline, the capacity dispatch) and
    the mesh constructors are among the files and submodules checked
    above (imported without jax) and import only torch, numpy, the
    standard library and the port."""
    path = PORT / module
    assert path in _port_files()
    name = "repro_torch." + module[:-3].replace("/", ".")
    assert name in [m.name for m in pkgutil.walk_packages(
        [str(PORT)], "repro_torch.")]
    std = {"__future__", "contextlib", "contextvars", "dataclasses",
           "datetime", "math", "os", "tempfile", "typing"}
    allowed = {"torch", "numpy", "repro_torch"} | std
    assert {m.split(".")[0] for m in _imports(path)} <= allowed, path


def test_accumulator_entries_stand_alone():
    """With ``jax`` and ``repro`` blocked (``launch/dryrun.py`` is held by
    the two tests above), the accumulator-mode and epilogue entries run
    their plain versions on CPU tensors, building nothing."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.kernels import pann_matmul as pm\n"
        "from repro_torch.kernels import pann_matmul_packed as pk\n"
        "x = torch.randn(4, 16)\n"
        "pos = torch.randint(0, 2, (7, 16, 8), dtype=torch.int8)\n"
        "neg = (1 - pos) * torch.randint(0, 2, (7, 16, 8), dtype=torch.int8)\n"
        "qp = torch.tensor([0.05, 60.0, 127.0, 0.0])\n"
        "sums = pm.pann_matmul_act_acc(x, pos, neg, qp)\n"
        "psums = pk.pann_matmul_packed_act_acc(x, pk.pack_planes(pos),\n"
        "                                      pk.pack_planes(neg), qp)\n"
        "assert torch.equal(sums, psums) and sums.dtype == torch.int32\n"
        "y = pm.pann_epilogue(sums, qp, torch.ones(8), torch.zeros(8,\n"
        "                     dtype=torch.int32))\n"
        "assert y.dtype == torch.float32 and build._libs == {}\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in "
        "sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
