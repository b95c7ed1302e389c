"""Port parity: elastic restart onto another mesh (`train(checkpoint_dir=)`
on a mesh, `checkpoint.restore_into(..., sharding_fn=)`, the gathered save),
check 5 of tests/_distributed_worker.py, over 4 gloo ranks spawned by
`tests/_torch_dist_worker.py`:
  - 2 gspmd steps of stablelm-3b smoke on (4,) ('data',), saved (every rank
    gathers the shards, rank 0 writes the reference's unsharded layout),
    resumed on (2, 2) ('data', 'model') for steps 3-4, against 4 straight
    steps on (4,) at the reference's rtol 2e-3;
  - a JAX checkpoint of step 2 resumed by the port on (2, 2), each rank
    keeping its shards, against JAX's straight 4 steps at the port-vs-JAX
    rtol 2e-4 (tests/test_torch_train.py).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_dist_worker import spawn  # noqa: E402

from repro.launch.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402

LOSS_RTOL = 2e-4      # port vs JAX
ELASTIC_RTOL = 2e-3   # tests/_distributed_worker.py check 5


def test_elastic_restart_onto_another_mesh(tmp_path):
    """Check 5: 2 steps on (4,) saved, resumed on (2, 2) for steps 3-4,
    against 4 straight steps on (4,); and a JAX checkpoint of step 2 resumed
    by the port on (2, 2) against JAX's straight 4 steps."""
    kw = {"arch": "stablelm-3b", "batch_size": 8, "seq_len": 32}
    _, _, want = jax_train(JaxTrainConfig(steps=4, **kw), lambda *_: None)
    jax_dir = tmp_path / "jax"
    jax_train(JaxTrainConfig(steps=2, checkpoint_dir=str(jax_dir), checkpoint_every=2, **kw),
              lambda *_: None)
    out = tmp_path / "losses.json"
    spawn("elastic", 4, str(tmp_path / "port"), str(out), str(jax_dir), timeout=240)
    runs = json.loads(out.read_text())
    assert len(runs["first"]) == 2 and len(runs["resumed"]) == 2
    np.testing.assert_allclose(runs["first"], runs["straight"][:2], rtol=ELASTIC_RTOL)
    np.testing.assert_allclose(runs["resumed"], runs["straight"][2:], rtol=ELASTIC_RTOL)
    np.testing.assert_allclose(runs["from_jax"], want[2:], rtol=LOSS_RTOL)
