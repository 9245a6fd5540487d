"""The port's experiment surface: spec JSON, results, the CLI, the device
rule, and the rule that the port imports nothing of JAX."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.api import RunResult as JaxRunResult
from repro.api import SimulatorTrainer as JaxSimulatorTrainer
from repro.api.trainers import SIM_WORKLOADS as JAX_SIM_WORKLOADS
from repro.cluster.faults import FaultPlan as JaxFaultPlan
from repro.core.simulator import WorkerPool as JaxWorkerPool
from repro_torch.api import (ExperimentSpec, RunResult, SimulatorTrainer,
                             run)
from repro_torch.api.cli import main
from repro_torch.convert import params_from_numpy

torch.set_num_threads(2)
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

SMOKE = dict(arch="mlp", mode="hybrid", schedule="step:50", horizon=3.0,
             smoke=True)


@pytest.mark.parametrize("fields", [
    {},
    dict(arch="cnn-cifar", smoke=False, optimizer="adamw", beta2=0.99,
         weight_decay=0.01, mode="sync", schedule=None),
    dict(pool=JaxWorkerPool(num_workers=7, delay_std=0.1),
         faults=JaxFaultPlan(stragglers=((0, 0.1),), kill=((1, 2.0),)),
         transport="host", listen="0.0.0.0:5555", slab_dtype="bf16"),
])
def test_spec_loads_reference_json(fields):
    ref = JaxSpec(**fields)
    ours = ExperimentSpec.from_json(ref.to_json())
    assert ours.to_json() == ref.to_json()
    assert JaxSpec.from_json(ours.to_json()) == ref


@pytest.mark.parametrize("backend", ["spmd", "cluster"])
def test_unported_backends_refuse(backend):
    """spmd is refused by the spec; the cluster backend runs in process,
    and a run on its wire transports is refused when it is built."""
    if backend == "spmd":
        with pytest.raises(NotImplementedError, match=backend):
            ExperimentSpec(backend=backend)
        return
    spec = ExperimentSpec(backend=backend, transport="socket")
    with pytest.raises(NotImplementedError, match=f"{backend}.*A10"):
        run(spec, device="cpu")


def test_spec_validation_matches_reference():
    for bad in (dict(mode="nope"), dict(flush_mode="x"),
                dict(optimizer="lion"), dict(horizon=0),
                dict(mode="hybrid", schedule="bogus:1"),
                dict(transport="host", listen="nowhere:port")):
        with pytest.raises(ValueError):
            JaxSpec(**bad)
        with pytest.raises(ValueError):
            ExperimentSpec(**bad)


def test_averaged_agrees_on_smoke_spec():
    """The same smoke spec on the same initial params and data."""
    jspec = JaxSpec(**SMOKE, pool=JaxWorkerPool(num_workers=5))
    workload = JAX_SIM_WORKLOADS["mlp"](jspec)
    loss, params, data, acc = workload
    jres = JaxSimulatorTrainer(*workload).run(jspec)
    from repro_torch.models.cnn import accuracy, mlp_clf_forward, nll_loss
    ours = SimulatorTrainer(
        lambda p, x, y: nll_loss(mlp_clf_forward(p, x), y),
        params_from_numpy(jax.tree.map(np.asarray, params)),
        jax.tree.map(lambda a: np.array(a, copy=True), data),
        lambda p, x, y: accuracy(mlp_clf_forward(p, x), y), device="cpu")
    tres = ours.run(ExperimentSpec.from_json(jspec.to_json()))
    assert (tres.num_updates, tres.num_gradients) == \
        (jres.num_updates, jres.num_gradients)
    assert tres.grid == jres.grid
    for k, v in jres.averaged().items():
        np.testing.assert_allclose(tres.averaged()[k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    back = JaxRunResult.from_json(tres.to_json())
    assert back.averaged() == tres.averaged()
    assert RunResult.from_json(tres.to_json()) == tres


def test_cli_simulate_smoke_on_cpu(capsys, tmp_path):
    out = tmp_path / "r.json"
    assert main(["simulate", "--smoke", "--device", "cpu", "--quiet",
                 "--out", str(out)]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["backend"] == "sim" and summary["num_updates"] > 0
    assert summary["extra"]["device"] == "cpu"
    full = RunResult.from_json(out.read_text())
    assert full.spec["pool"]["num_workers"] == 5
    assert np.isfinite(list(full.averaged().values())).all()


def test_cli_schedules_and_bad_spec(capsys):
    assert main(["schedules"]) == 0
    assert "step" in capsys.readouterr().out
    assert main(["simulate", "--smoke", "--device", "cpu",
                 "--schedule", "bogus:1"]) == 2


def test_no_cuda_means_error_not_cpu(monkeypatch):
    """Without --device cpu a host with no CUDA raises; nothing runs on
    the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["simulate", "--smoke", "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(ExperimentSpec(**SMOKE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimulatorTrainer()


def test_port_imports_no_jax():
    """Importing the port and every submodule loads neither jax nor any
    module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'repro' "
        "or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('core.simulator', 'models.model', 'models.attention', "
        "'launch.serve', 'kernels.rmsnorm', 'kernels.flash_attention', "
        "'configs.h2o_danube_18b', 'checkpoint.ckpt', 'obs.telemetry', "
        "'data.pipeline', 'cluster.faults', 'cluster.transport', "
        "'cluster.server', 'cluster.worker', 'cluster.runtime', "
        "'cluster.trainer'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names no module of JAX or of the JAX package in any
    import, at top level or inside a function."""
    import ast
    path = os.path.join(os.path.dirname(SRC), "chip_smoke.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.launch" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
