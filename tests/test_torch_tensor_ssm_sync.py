"""The ``model`` axis of the SPMD trainer for mamba and the xLSTM cells in
sync runs: jamba-v0.1-52b smoke (mamba + MLP, mamba + MoE) and
xlstm-350m smoke (mLSTM + sLSTM) on four gloo ranks against the
reference's ``run_training`` on four forced host devices at the same
``mesh_model``, float32 at M 4 and jamba in bf16 at M 2.  The hybrid
runs and the rest are ``test_torch_tensor_ssm.py``; the harness is
``test_torch_tensor.py``'s."""
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec

from test_torch_tensor import (BF16_TOL, _REF_SCRIPT, _against_reference,
                               _finish, _forced, _npz, _start)
from test_torch_tensor_ssm import JAMBA, XLSTM, _close, _groups_equal

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_sync_mesh_model_4_matches_reference(tmp_path, arch):
    """The same smoke variants, float32, sync at ``mesh_model=4`` (data
    1 x model 4: one MoE expert, a quarter of the inner channels and one
    xLSTM head a rank): losses (and aux) and final params within rtol
    1e-5 / atol 1e-6 of the reference, the whole leaves equal on all
    four ranks."""
    st, hp, hr, got, want = _against_reference(tmp_path, arch, "sync", 4)
    assert [h["group_size"] for h in hp] == [1] * 4
    assert len(set(st["whole_digest_by_rank"])) == 1
    keys = ["loss"] + (["aux"] if arch == JAMBA else [])
    _close(hp, hr, keys, got, want)


def test_jamba_sync_mesh_model_2_bf16_matches_reference(tmp_path):
    """jamba-v0.1-52b smoke in bf16, sync at ``mesh_model=2``: ``proj``
    summed over the model group in float32 and rounded once to bf16,
    the row-parallel outputs summed in bf16; losses and aux within
    C.45's bf16 tolerance of the reference, 8 rows of 128 as the float32
    hybrid run takes them.  The final params are held
    leaf by leaf within twice the reference's own spread between its
    ``mesh_model`` 1 and 2 runs, as C.47 holds top-k routing on bf16
    activations."""
    spec1 = tmp_path / "spec1.json"
    spec1.write_text(JaxSpec(
        arch=JAMBA, backend="spmd", mode="sync", steps=4, batch=8, seq=128,
        smoke=True, log_every=1, mesh_model=1).to_json())
    (tmp_path / "ref1.py").write_text(textwrap.dedent(_REF_SCRIPT))
    ref1 = _start([sys.executable, str(tmp_path / "ref1.py"), str(spec1),
                   str(tmp_path / "ref1_final"), "bfloat16"], _forced(4))
    st, hp, hr, got, want = _against_reference(
        tmp_path, JAMBA, "sync", 2, dtype="bfloat16", seq=128)
    _finish(ref1, "the reference's run_training at mesh_model 1")
    other = _npz(tmp_path / "ref1_final.npz")
    assert _groups_equal(st["routing_digest_by_rank"], 2)
    assert _groups_equal(st["whole_digest_by_rank"], 2)
    for key in ("loss", "aux"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], err_msg=key,
                                   **BF16_TOL)
    assert sorted(other) == sorted(want)
    for k in want:
        spread = float(np.abs(other[k] - want[k]).max())
        tol = BF16_TOL["atol"] + BF16_TOL["rtol"] * float(
            np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= \
            max(2 * spread, tol), k
