"""Port parity: the rest of the 'model' axis — sequence parallelism, the
vocab-parallel loss and greedy pick, tensor parallelism inside the experts
under `moe-ep-data` and the partial-softmax combine over sequence-sharded
caches (`repro_torch/models/tensor_parallel.py`, `models/sharding.py`, the
blocks, `launch/train.make_train_step(..., seq_parallel=True)`) vs the JAX
package's single-device model.

Each case's weights are the port's draw, held by both packages in the
reference's tree layout (`interop`); the ranks (gloo, spawned once a mesh by
`tests/_torch_dist_worker.py sp`, the three meshes at once while this
process computes the JAX side) compute on (1, 2), (2, 2) and (1, 4)
("data", "model") meshes:
  - sequence parallelism (the reference's `seq-parallel` rule): the forward
    logits of the whole batch at 2e-4, and the loss (`loss_fn`, MoE aux
    included) and every gradient leaf in `train()`'s layout, at rtol 2e-4
    and rtol 2e-4 + atol 1e-5 (tests/test_torch_tp.py's bounds), for the
    batch's 16 positions and for its first 15 (a sequence that does not
    divide the 'model' size, which the rule's guard keeps whole); every
    gradient replicated over 'model' bit-equal across the peers.  The
    cases: every text arch's smoke config, whisper-base (24 frames, the
    encoder sharded too), internvl2-26b (16 patches before the tokens: 32
    and 31 positions), tests/test_torch_tp.py's GQA case of 6 query heads on
    3 KV heads and rwkv6-3b with 2 heads, and stablelm-3b with a vocab of
    509, which divides no mesh (the loss stays the whole-vocab one); every
    other case's unembedding is vocab-split, so its loss is the
    vocab-parallel one;
  - the vocab-parallel loss and argmax on seeded logits against the
    whole-vocab versions: labels of -1 and on each slice's first and last
    id, the loss within 1e-6 and its gradient within 1e-6; the argmax with
    ties planted across slices equal to `torch.argmax` of the whole logits;
  - the combine: prefill and 3 greedy decode steps through the dry run's
    sharded serving layout with real tensors (4 prompts of 8, a cache of
    12), the logits of every step at 2e-4 against JAX's prefill and decode:
    the GQA case under `kv-seq-sharded` (on (1, 4) the first step finds no
    valid slot on the last rank), recurrentgemma-9b with a window of 4
    under `kv-seq-sharded` (its local layers' ring buffer, one slot a rank
    on (1, 4), the prompt past the window) and minicpm3-4b's latent cache
    in the baseline layout;
  - `moe-ep-data` (`moe_expert_axis="data"`): qwen3-moe-235b-a22b and
    arctic-480b, the loss and every gradient at the bounds above, every
    expert stack kept split over 'model' on d_ff.
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
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.interop import tree_from_model  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

TOL = 2e-4                 # tests/test_torch_tp.py's bounds
GRAD_ATOL = 1e-5
VOCAB_TOL = 1e-6           # the vocab-parallel loss against the whole-vocab one (f32)
MESHES = {"1x2": 2, "2x2": 4, "1x4": 4}
BATCH, SEQ = 4, 16
PROMPT, NEW = 8, 4         # the combine's prompts and steps: a cache of 12 slots
TEXT = ["stablelm-3b", "gemma3-4b", "recurrentgemma-9b", "rwkv6-3b", "minicpm3-4b",
        "qwen3-moe-235b-a22b", "arctic-480b", "command-r-plus-104b"]


def _smoke(arch, **change):
    cfg = jax_configs.get(arch).scaled_down()
    return dataclasses.replace(cfg, dtype="float32", **change)


GQA = _smoke("stablelm-3b", name="gqa-6-on-3", num_heads=6, num_kv_heads=3)
SP = {**{a: _smoke(a) for a in TEXT},
      "whisper-base": _smoke("whisper-base"),
      "internvl2-26b": _smoke("internvl2-26b"),
      "gqa-6-on-3": GQA,
      "rwkv6-2-heads": _smoke("rwkv6-3b", name="rwkv6-2-heads", rwkv_head_dim=64),
      "vocab-509": _smoke("stablelm-3b", name="vocab-509", vocab_size=509)}
# name -> (config, the dry run's variant)
COMBINE = {"gqa-6-on-3-serve": (dataclasses.replace(GQA, name="gqa-6-on-3-serve"),
                                "kv-seq-sharded"),
           "recurrentgemma-window-4": (_smoke("recurrentgemma-9b", name="recurrentgemma-window-4",
                                              window=4), "kv-seq-sharded"),
           "minicpm3-4b-serve": (_smoke("minicpm3-4b", name="minicpm3-4b-serve"), "baseline")}
EP = ["qwen3-moe-235b-a22b", "arctic-480b"]


def _batch(cfg, seq=SEQ, batch=BATCH):
    out = SyntheticLM(cfg.vocab_size, seq, seed=0).global_batch(0, batch, 1)
    rng = np.random.default_rng(1)
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        out["patches"] = rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return out


def _write_case(d, name, cfg, batch, serve=None):
    """The case's files for the ranks; returns its weights as JAX arrays."""
    tree = tree_from_model(init_params(port_cfg(cfg), torch.Generator().manual_seed(0), "cpu"))
    np.savez(d / f"{name}.npz", **flatten(tree))
    np.savez(d / f"{name}.batch.npz", **batch)
    fields = dataclasses.asdict(cfg)
    fields["_serve"] = serve or {}
    (d / f"{name}.json").write_text(json.dumps(fields))
    return jax.tree.map(jnp.asarray, tree)


def _jax_train(cfg, params, batch):
    # without remat, as tests/test_torch_tp.py
    cfg = dataclasses.replace(cfg, remat=False)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def side(p):
        logits = jax_forward(cfg, p, batch, mode="train").logits
        return logits, jax.value_and_grad(lambda q: jax_loss_fn(cfg, q, batch), has_aux=True)(p)

    logits, ((loss, metrics), grads) = side(params)
    return {"logits": np.asarray(logits), "loss": float(loss), "nll": float(metrics["nll"]),
            "aux": float(metrics["aux"]), "grads": flatten(jax.tree.map(np.asarray, grads))}


def _jax_sp(name, params):
    cfg = SP[name]
    batch = _batch(cfg)
    odd = {k: v[:, :-1] if k in ("tokens", "labels") else v for k, v in batch.items()}
    return {"": _jax_train(cfg, params, batch), "odd_": _jax_train(cfg, params, odd)}


def _jax_combine(name, params):
    """JAX's prefill and greedy decode steps, as its `serve_requests` runs them."""
    cfg = dataclasses.replace(COMBINE[name][0], remat=False)
    tokens = jnp.asarray(_batch(cfg, PROMPT)["tokens"])
    logits, caches = jax.jit(lambda p, t: jax_prefill(cfg, p, {"tokens": t},
                                                      max_seq=PROMPT + NEW))(params, tokens)
    step = jax.jit(lambda p, t, c: jax_decode_step(cfg, p, t, c))
    steps = [logits]
    for _ in range(NEW - 1):
        logits, caches = step(params, jnp.argmax(logits, -1)[:, None], caches)
        steps.append(logits)
    return np.asarray(jnp.stack(steps, 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: {case: (arrays, facts)}} and {mesh: vocab checks} of the three
    meshes' ranks, and JAX's side of every case: computed once."""
    d = tmp_path_factory.mktemp("sp")
    jobs = [(n, cfg, _batch(cfg), None) for n, cfg in SP.items()]
    jobs += [(n, cfg, {"tokens": _batch(cfg, PROMPT)["tokens"]},
              {"new_tokens": NEW, "variant": variant}) for n, (cfg, variant) in COMBINE.items()]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        params = dict(zip([j[0] for j in jobs],
                          pool.map(lambda j: _write_case(d, *j), jobs)))
    (d / "plan.json").write_text(json.dumps({"sp": list(SP), "combine": list(COMBINE),
                                             "ep": EP}))
    with concurrent.futures.ThreadPoolExecutor(len(MESHES) + 4) as pool:
        ranks = [pool.submit(spawn, "sp", n, str(d), str(d / shape), shape, timeout=600)
                 for shape, n in MESHES.items()]
        sp = dict(zip(SP, pool.map(lambda name: _jax_sp(name, params[name]), SP)))
        combine = dict(zip(COMBINE, pool.map(lambda name: _jax_combine(name, params[name]),
                                             COMBINE)))
        for job in ranks:
            job.result()
    got = {shape: {name: (dict(np.load(d / f"{shape}.{name}.npz")),
                          json.loads((d / f"{shape}.{name}.json").read_text()))
                   for name in [*SP, *COMBINE, *(f"ep-{n}" for n in EP)]}
           for shape in MESHES}
    vocab = {shape: json.loads((d / f"{shape}.vocab.json").read_text()) for shape in MESHES}
    return got, vocab, {"sp": sp, "combine": combine}


def _grads(arrays, prefix="grad/"):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _check_loss_and_grads(facts, arrays, want, tag=""):
    for key in ("loss", "nll", "aux"):
        np.testing.assert_allclose(facts[tag + key], want[key], rtol=TOL, atol=1e-7,
                                   err_msg=tag + key)
    grads = _grads(arrays, f"{tag}grad/")
    assert sorted(grads) == sorted(want["grads"])
    for key, g in want["grads"].items():
        np.testing.assert_allclose(grads[key], g, rtol=TOL, atol=GRAD_ATOL, err_msg=tag + key)


@pytest.mark.parametrize("name", list(SP))
@pytest.mark.parametrize("shape", list(MESHES))
def test_sequence_parallel_equals_jax(runs, shape, name):
    got, _, want = runs
    arrays, facts = got[shape][name]
    w = want["sp"][name]
    np.testing.assert_allclose(arrays["logits"], w[""]["logits"], rtol=TOL, atol=TOL)
    for tag in ("", "odd_"):  # the sequence divides the 'model' size; it does not
        _check_loss_and_grads(facts, arrays, w[tag], tag)
        assert facts[tag + "grads_unequal"] == []
    # sliced where the sequence divides: the row-parallel sums reduce-scattered
    # (beside the gradients' reductions to their shards, in both runs)
    assert facts["collectives"]["reduce-scatter"]["count"] > \
        facts["odd_collectives"]["reduce-scatter"]["count"]
    assert facts["vocab_split"] == (name != "vocab-509")


@pytest.mark.parametrize("shape", list(MESHES))
def test_vocab_parallel_loss_and_argmax_equal_the_whole_vocabs(runs, shape):
    vocab = runs[1][shape]
    got, want = vocab["nll"]
    assert abs(got - want) <= VOCAB_TOL * abs(want)
    assert vocab["grad_err"] <= VOCAB_TOL
    assert vocab["argmax_equal"] and vocab["argmax_tied_rows"] >= 2


@pytest.mark.parametrize("name", list(COMBINE))
@pytest.mark.parametrize("shape", list(MESHES))
def test_sequence_sharded_caches_combine_to_jaxs_decode(runs, shape, name):
    got, _, want = runs
    arrays, facts = got[shape][name]
    np.testing.assert_allclose(arrays["served_logits"], want["combine"][name],
                               rtol=TOL, atol=TOL)
    # the combine ran: the attention caches are held as their sequence's shard
    expected = ["mix/c_kv", "mix/k_rope"] if "minicpm3" in name else ["mix/k", "mix/v"]
    assert facts["seq_sharded_leaves"] == expected


@pytest.mark.parametrize("name", EP)
@pytest.mark.parametrize("shape", list(MESHES))
def test_tensor_parallel_experts_under_moe_ep_data_equal_jax(runs, shape, name):
    got, _, want = runs
    arrays, facts = got[shape][f"ep-{name}"]
    _check_loss_and_grads(facts, arrays, want["sp"][name][""])
    layers = SP[name].num_layers
    assert len(facts["experts_split"]) == 3 * layers
