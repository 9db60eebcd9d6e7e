"""The port's precision gate (`python -m gan2shape_torch.tools.
check_precision`) on the CPU at 64², 3 iterations a step and 2 pseudo
samples: it writes its JSON with a verdict for every step and faster
policy, restores the policy, and on the CPU, where TF32 does not exist,
'high' repeats 'highest' loss for loss while the bf16 activations of
'default' do change the losses."""

import json

import numpy as np
import pytest
import torch

from gan2shape_torch.tools import check_precision as gate
from gan2shape_torch.utils import precision as prec


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_gate_on_cpu_writes_every_step(tmp_path):
    out = tmp_path / "precision_check_torch.json"
    with prec.policy("highest", "float32"):
        rc = gate.main(["--device", "cpu", "--size", "64", "--iters", "3",
                        "--n-proj", "2", "--out", str(out)])
        # the policy in force before the gate is in force after it
        assert prec.matmul_precision() == "highest"
        assert prec.act_dtype() == torch.float32
    res = json.loads(out.read_text())
    assert rc == (0 if res["ok"] else 1)
    assert res["device"] == "cpu" and res["size"] == 64
    assert res["iters"] == 3 and res["n_proj"] == 2
    assert set(res["policies"]) == {"highest", "high", "default"}
    assert set(res["steps"]) == set(gate.STEPS)
    runs = res["policies"]
    for name, run in runs.items():
        assert (run["matmul_precision"], run["act_dtype"]) == \
            gate.POLICIES[name]
        assert len(run["losses"]["prior"]) == gate.N_EPOCHS_PRIOR
        for step in ("step1", "step2", "step3"):
            assert len(run["losses"][step]) == 3
        assert all(np.isfinite(v).all() for v in run["losses"].values())
    for step, by_policy in res["steps"].items():
        assert set(by_policy) == {"high", "default"}
        for v in by_policy.values():
            assert v["finite"] and v["bound"] == gate.MAX_REL_DEV[step]
            assert {"tail_mean", "tail_mean_reference", "tail_rel_dev",
                    "decreasing", "pass"} <= set(v)
        # TF32 does not exist on the CPU: 'high' is 'highest' bit for bit
        assert runs["high"]["losses"][step] == \
            runs["highest"]["losses"][step]
        assert by_policy["high"]["tail_rel_dev"] == 0.0
    # the bf16 activations apply on the CPU too
    assert runs["default"]["losses"]["step1"] != \
        runs["highest"]["losses"]["step1"]
