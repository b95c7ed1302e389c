"""Port parity: tensor parallelism over the mesh's 'model' axis
(`repro_torch/models/tensor_parallel.py`, the compute layout of
`launch/shardings.py`, the blocks' splits, `launch/train.py`'s layout)
vs the JAX package's single-device model.

Each case's weights are drawn once and held by both packages in the
reference's tree layout (`interop`); the ranks (gloo, spawned once a mesh
by `tests/_torch_dist_worker.py tp`, the three meshes at once while this
process computes the JAX side) shard them under the rule table and
compute, on (1, 2), (2, 2) and (1, 4) ("data", "model") meshes:
  - the forward logits of the whole batch, at 2e-4;
  - the loss (`loss_fn`, MoE aux included) in `train()`'s layout (rows over
    'data', the 'model' peers holding the same rows), at rtol 2e-4, and
    every gradient leaf gathered whole, at rtol 2e-4 + atol 1e-5 (the mesh
    tests' bound, tests/test_torch_mesh.py; the atol of
    tests/test_torch_train.py);
  - served ids, from the serving layout (fsdp=False): `serve_requests`
    (the text archs; whisper-base and internvl2-26b, which need frames and
    patches, through prefill and greedy decode steps) against JAX's greedy
    prefill and decode steps as its `serve_requests` runs them, ids equal;
    the prefill and decode logits at 2e-4; the same ids on every rank;
  - the caches' local shapes after prefill;
  - every gradient replicated over 'model' bit-equal across the 'model'
    peers, and on (2, 2) every such parameter after 2 `train()` steps;
  - the sharded init (`launch.shardings.init_sharded`) equal to `shard_model` of
    the unsharded init bit for bit, shard for shard.
The cases: every text arch's smoke config, whisper-base, internvl2-26b, a
GQA config whose 6 query heads split over 2 ranks with 3 KV heads (rank 0's
query heads read KV heads 0, 0, 1: they span two, unevenly), and rwkv6-3b
with 2 heads (they do not divide over 4 ranks: the block computes
replicated there).  Also: a tensor-parallel run's checkpoint resumed by the
reference and, on another mesh, by the port.

Every case's weights are the port's draw, but one: rwkv6-3b's smoke config
drawn by JAX's own `init_params` (seed 0).  Its gradients are ill
conditioned in float32: a few (token, head) pairs of RWKV-6's group norm
have a variance below its eps (1e-5), whose rsqrt then scales their
rounding errors up to 316 times, and JAX's f32 gradients themselves lie up
to 2.4e-4 (relative to each leaf's largest element) from the float64
gradient and the tensor-parallel ones up to 5.5e-4; two f32 evaluations
then do not meet 2e-4 of each other elementwise.
So that case's gradients are held to a float64 evaluation of the same
weights instead (`tp64` ranks): the tensor-parallel f64 gradients equal the
single-rank f64 ones to 1e-9 (a fault of the split would be of order 1),
and the f32 gradients of both packages lie within 1e-3 of them.  Its
logits, loss and served ids are held to JAX as every case's are.
"""
import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_dist_worker import spawn  # noqa: E402
from _torch_parity import flatten, port_cfg  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.launch.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.launch.train import train as jax_train  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.models import init_params, tensor_parallel  # noqa: E402

TOL = 2e-4                 # the mesh tests' bound (tests/test_torch_mesh.py)
GRAD_ATOL = 1e-5           # tests/test_torch_train.py
ELASTIC_RTOL = 2e-3        # tests/_distributed_worker.py check 5
F64_RTOL = 1e-9            # f64 tensor-parallel against f64 on one rank (measured 6.1e-13)
F32_FROM_F64 = 1e-3        # an f32 gradient from the f64 one, relative to the leaf's largest
MESHES = {"1x2": 2, "2x2": 4, "1x4": 4}
BATCH, SEQ, NEW = 4, 16, 4
TEXT = ["stablelm-3b", "gemma3-4b", "recurrentgemma-9b", "rwkv6-3b", "minicpm3-4b",
        "qwen3-moe-235b-a22b", "arctic-480b", "command-r-plus-104b"]


def _smoke(arch, **change):
    cfg = jax_configs.get(arch).scaled_down()
    return dataclasses.replace(cfg, dtype="float32", **change)


# name -> (JAX config, how it is served, the arch `train()` runs or None)
CASES = {**{a: (_smoke(a), "requests", a) for a in TEXT},
         "whisper-base": (_smoke("whisper-base"), "steps", None),
         "internvl2-26b": (_smoke("internvl2-26b"), "steps", None),
         "gqa-6-on-3": (_smoke("stablelm-3b", name="gqa-6-on-3", num_heads=6,
                               num_kv_heads=3), "requests", None),
         "rwkv6-2-heads": (_smoke("rwkv6-3b", name="rwkv6-2-heads", rwkv_head_dim=64),
                           "requests", None),
         "rwkv6-3b-jax-draw": (_smoke("rwkv6-3b"), "requests", None)}
JAX_DRAWN = ("rwkv6-3b-jax-draw",)   # weights from JAX's init_params; gradients held to f64


def _batch(cfg):
    batch = SyntheticLM(cfg.vocab_size, SEQ, seed=0).global_batch(0, BATCH, 1)
    rng = np.random.default_rng(1)
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        batch["patches"] = rng.standard_normal(
            (BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def _write_case(d, name):
    """The case's files for the ranks; returns its weights as JAX arrays.
    The weights are the port's draw (`init_params`, the reference's scales),
    laid out as the reference's tree (`interop.tree_from_model`): the JAX
    package reads the same numbers without compiling an init.  JAX_DRAWN's
    are JAX's own draw."""
    cfg, served, train_arch = CASES[name]
    if name in JAX_DRAWN:
        params = jax_init_params(cfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
    else:
        tree = tree_from_model(init_params(port_cfg(cfg), torch.Generator().manual_seed(0),
                                           "cpu"))
        params = jax.tree.map(jnp.asarray, tree)
    np.savez(d / f"{name}.npz", **flatten(tree))
    np.savez(d / f"{name}.batch.npz", **_batch(cfg))
    fields = dataclasses.asdict(cfg)
    fields["_serve"] = {"served": served, "new_tokens": NEW, "train": train_arch}
    (d / f"{name}.json").write_text(json.dumps(fields))
    return params


def _jax_side(name, params):
    cfg, served, _ = CASES[name]
    # without remat: JAX's `jax.checkpoint` moves rwkv6-3b's gradients
    # (tests/test_torch_train.py::test_recurrent_loss_and_grads_match_jax)
    cfg = dataclasses.replace(cfg, remat=False)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}

    @jax.jit
    def train_side(p):
        logits = jax_forward(cfg, p, batch, mode="train").logits
        return logits, jax.value_and_grad(lambda q: jax_loss_fn(cfg, q, batch), has_aux=True)(p)

    logits, ((loss, metrics), grads) = train_side(params)
    out = {"logits": np.asarray(logits), "loss": float(loss), "nll": float(metrics["nll"]),
           "aux": float(metrics["aux"]), "grads": flatten(jax.tree.map(np.asarray, grads))}
    # greedy serving as JAX's `serve_requests` runs it (prefill, then its
    # jitted decode step), the prefill jitted too; frames and patches passed
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, caches = jax.jit(lambda p, i: jax_prefill(cfg, p, i, max_seq=SEQ + NEW))(
        params, inputs)
    step = jax.jit(lambda p, t, c: jax_decode_step(cfg, p, t, c))
    steps = [logits]
    for _ in range(NEW - 1):
        logits, caches = step(params, jnp.argmax(logits, -1)[:, None], caches)
        steps.append(logits)
    out["served_logits"] = np.asarray(jnp.stack(steps, 1))
    out["ids"] = np.argmax(out["served_logits"], -1).tolist()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {case: (arrays, facts)}} of the three meshes' ranks, {case:
    JAX's side}, and the directory where the `tp_restart` ranks (run
    meanwhile) left their checkpoint and losses and the `tp64` ranks their
    float64 gradients of JAX_DRAWN: computed once."""
    d = tmp_path_factory.mktemp("tp")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        params = dict(zip(CASES, pool.map(lambda name: _write_case(d, name), CASES)))
    with concurrent.futures.ThreadPoolExecutor(len(MESHES) + 4) as pool:
        jobs = [pool.submit(spawn, "tp", n, str(d), str(d / shape), shape, *CASES, timeout=300)
                for shape, n in MESHES.items()]
        restart = pool.submit(spawn, "tp_restart", 2, str(d / "ckpt"), str(d / "restart.json"),
                              timeout=300)
        jobs += [pool.submit(spawn, "tp64", n, str(d), str(d / f"{shape}.f64"), shape, name,
                             timeout=300)
                 for shape, n in MESHES.items() for name in JAX_DRAWN]
        want = dict(zip(params, pool.map(lambda item: _jax_side(*item), params.items())))
        for job in [*jobs, restart]:
            job.result()
    got = {shape: {name: (dict(np.load(d / f"{shape}.{name}.npz")),
                          json.loads((d / f"{shape}.{name}.json").read_text()))
                   for name in CASES}
           for shape in MESHES}
    return got, want, d


def _expected_cache_shapes(cfg, tp):
    """The cache leaves a rank holds (`models.model.init_caches`) under the
    split rules, written out: KV heads split where the query heads and the
    KV heads divide, one KV head a rank where each rank's query heads read
    one, one a query head where they read several; RG-LRU channels and
    RWKV-6 heads where they divide; MLA's latents and the last-token states
    whole."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hq % tp:
        kv = hkv
    elif hkv % tp == 0:
        kv = hkv // tp
    else:
        kv = 1 if (hq // hkv) % (hq // tp) == 0 else hq // tp
    w = cfg.rglru_width or cfg.d_model
    w_l = w // tp if w % tp == 0 else w
    heads = cfg.d_model // cfg.rwkv_head_dim
    h_l = heads // tp if heads % tp == 0 else heads
    out = []
    for kind in cfg.layer_kinds:
        if kind in ("attn", "local"):
            s = min(SEQ + NEW, cfg.window) if kind == "local" else SEQ + NEW
            c = {"mix/k": [BATCH, kv, s, hd], "mix/v": [BATCH, kv, s, hd],
                 "mix/slot_pos": [s]}
        elif kind == "mla":
            m = cfg.mla
            c = {"mix/c_kv": [BATCH, SEQ + NEW, m.kv_lora_rank],
                 "mix/k_rope": [BATCH, SEQ + NEW, m.qk_rope_head_dim]}
        elif kind == "rglru":
            c = {"mix/h": [BATCH, w_l], "mix/conv_tail": [BATCH, cfg.conv_kernel - 1, w_l]}
        else:
            c = {"mix/last": [BATCH, cfg.d_model],
                 "mix/wkv": [BATCH, h_l, cfg.rwkv_head_dim, cfg.rwkv_head_dim],
                 "cmix": [BATCH, cfg.d_model]}
        if cfg.enc_dec:
            c |= {"cross_k": [BATCH, kv, cfg.encoder_seq, hd],
                  "cross_v": [BATCH, kv, cfg.encoder_seq, hd]}
        out.append(c)
    return out


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", list(MESHES))
def test_tensor_parallel_equals_jax(runs, shape, name):
    got, want, _ = runs
    arrays, facts = got[shape][name]
    w = want[name]
    cfg = CASES[name][0]
    np.testing.assert_allclose(arrays["logits"], w["logits"], rtol=TOL, atol=TOL)
    for key in ("loss", "nll", "aux"):
        np.testing.assert_allclose(facts[key], w[key], rtol=TOL, atol=1e-7, err_msg=key)
    grads = {k[len("grad/"):]: v for k, v in arrays.items() if k.startswith("grad/")}
    assert sorted(grads) == sorted(w["grads"])
    if name not in JAX_DRAWN:  # theirs: test_ill_conditioned_gradients_lie_within_rounding
        for key, g in w["grads"].items():
            np.testing.assert_allclose(grads[key], g, rtol=TOL, atol=GRAD_ATOL, err_msg=key)
    assert facts["ids"] == w["ids"]
    if CASES[name][1] == "requests":
        assert facts["served_ids"] == w["ids"]
    assert all(ids == facts["ids"] for ids in facts["ids_every_rank"])
    np.testing.assert_allclose(arrays["served_logits"], w["served_logits"],
                               rtol=TOL, atol=TOL)
    shapes = [{k: v for k, v in c.items() if k != "mix/pos"} for c in facts["cache_shapes"]]
    assert shapes == _expected_cache_shapes(cfg, int(shape.split("x")[1]))
    assert facts["grads_unequal"] == []
    assert facts["params_unequal"] == []
    assert facts["sharded_init_equal"]
    if CASES[name][2] and shape == "2x2":
        assert len(facts["train_losses"]) == 2 and all(np.isfinite(facts["train_losses"]))


@pytest.mark.parametrize("name", JAX_DRAWN)
@pytest.mark.parametrize("shape", list(MESHES))
def test_ill_conditioned_gradients_lie_within_rounding_of_float64(runs, shape, name):
    """JAX_DRAWN's gradients (module docstring): in float64 the tensor-
    parallel run equals one rank's to F64_RTOL, loss and every leaf; in
    float32 the tensor-parallel gradients and JAX's each lie within
    F32_FROM_F64 of the f64 ones, relative to each leaf's largest element."""
    got, want, d = runs
    f64 = dict(np.load(d / f"{shape}.f64.{name}.npz"))
    facts = json.loads((d / f"{shape}.f64.{name}.json").read_text())
    one = {k[len("one/"):]: v for k, v in f64.items() if k.startswith("one/")}
    assert sorted(one) == sorted(want[name]["grads"])
    np.testing.assert_allclose(facts["loss"], facts["one_loss"], rtol=1e-12)
    f32 = {"tensor parallel": {k[len("grad/"):]: v for k, v in got[shape][name][0].items()
                               if k.startswith("grad/")},
           "JAX": want[name]["grads"]}
    for key, exact in one.items():
        scale = np.abs(exact).max()
        assert np.abs(f64[f"tp/{key}"] - exact).max() <= F64_RTOL * scale, key
        for who, grads in f32.items():
            err = np.abs(grads[key].astype(np.float64) - exact).max()
            assert err <= F32_FROM_F64 * scale, f"{who} {key}: {err / scale:.3g}"


def test_kv_heads_a_rank_reads():
    """Query head i reads KV head i // (hq / hkv): each rank keeps the KV
    heads its query heads read, once where each serves the same number of
    them, else one a query head."""
    assert tensor_parallel.kv_heads(6, 3, 2, 0) == [0, 0, 1]     # spans two, unevenly
    assert tensor_parallel.kv_heads(6, 3, 2, 1) == [1, 2, 2]
    assert tensor_parallel.kv_heads(16, 1, 4, 3) == [0]           # MQA
    assert tensor_parallel.kv_heads(96, 8, 16, 5) == [2]          # command-r at tp = 16
    assert tensor_parallel.kv_heads(96, 8, 16, 15) == [7]
    assert tensor_parallel.kv_heads(8, 2, 4, 2) == [1]


def test_a_tensor_parallel_checkpoint_restores_in_the_reference_and_on_another_mesh(runs):
    """2 gloo ranks (`tp_restart`, spawned by the `runs` fixture): stablelm-3b
    smoke, 2 gspmd steps on (1, 2) saved (the storage layout is the rule
    table's, gathered and written by rank 0), resumed by the port on (2, 1)
    and by the reference's `train()`; both resumed runs' steps 3-4 against
    the port's straight (1, 2) run."""
    d = runs[2]
    restart = json.loads((d / "restart.json").read_text())
    assert len(restart["first"]) == 2 and len(restart["resumed"]) == 2
    np.testing.assert_allclose(restart["first"], restart["straight"][:2], rtol=ELASTIC_RTOL)
    np.testing.assert_allclose(restart["resumed"], restart["straight"][2:], rtol=ELASTIC_RTOL)
    _, _, ref = jax_train(JaxTrainConfig(arch="stablelm-3b", batch_size=8, seq_len=32, steps=4,
                                         checkpoint_dir=str(d / "ckpt"), checkpoint_every=100),
                          lambda *_: None)
    np.testing.assert_allclose(ref, restart["straight"][2:], rtol=TOL)
