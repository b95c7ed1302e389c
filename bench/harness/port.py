"""The benchmark's only door into the program under test, the port
`repro_torch`: its configuration type, its model built on the benchmark's
weights, its training step and its serving entry.  Nothing else of the
benchmark imports the program, and the plain references never do."""
from __future__ import annotations

import dataclasses

import torch


def arch_config(config: dict):
    """The port's `ArchConfig` of a configuration file's `arch` (lists as
    tuples, as the dataclass keeps them)."""
    from repro_torch.models.config import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    arch = {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["arch"].items() if k in fields}
    return ArchConfig(**arch)


def model(cfg, tree: dict):
    """The port's `Model` holding the benchmark's weights (the same tensors,
    as trainable parameters: an update writes into them)."""
    from repro_torch.models.model import Model
    return Model(cfg, tree["embed"], tree["unembed"], tree["final_norm"], tree["blocks"])


@dataclasses.dataclass
class Trainer:
    """`make_train_step` of a `TrainConfig` on the world this process is
    in, with the model's AdamW state: `step(batch)` runs one step and
    returns its metrics (device tensors)."""

    model: object
    step_fn: object
    opt_state: object
    ef: object = None

    def step(self, batch: dict) -> dict:
        self.opt_state, metrics, self.ef = self.step_fn(self.model, self.opt_state, batch,
                                                        self.ef)
        return metrics


def trainer(cfg, tree: dict, traffic: dict) -> Trainer:
    from repro_torch.collectives import make_error_feedback_state
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw_init
    tc = train_mod.TrainConfig(
        arch=cfg.name, scale="full", steps=traffic["schedule_steps"],
        batch_size=traffic["batch_per_rank"] * traffic["ranks"], seq_len=traffic["seq"],
        lr=traffic["lr"], warmup=traffic["warmup"], grad_sync=traffic["grad_sync"])
    world = train_mod.current_world()
    if world.size != traffic["ranks"]:
        raise ValueError(f"{traffic['ranks']} ranks in the mix, {world.size} in the world")
    lay = train_mod.layout(tc, world, None)
    m = model(cfg, tree)
    params = list(m.parameters())
    ef = make_error_feedback_state(params) if tc.grad_sync == "bridge-compressed" else None
    return Trainer(m, train_mod.make_train_step(tc, lay), adamw_init(params), ef)


def sync_plan(traffic: dict, grad_bytes: int):
    """The plan `sync_gradients` picks for this payload, with its predicted
    time under the port's assumed H100 NVLink costs (printed, never a
    metric)."""
    from repro_torch.collectives import gradient_sync_plan
    from repro_torch.core.cost_model import H100_NVLINK
    return gradient_sync_plan(traffic["ranks"], grad_bytes, H100_NVLINK)


def serve(cfg, m, prompts, new_tokens: int, progress, device) -> list[list[int]]:
    """The served ids of each prompt row, through `serve_requests` as its
    users call it (the decode captured as a graph on a card, eager on the
    CPU: the program decides)."""
    from repro_torch.launch.serve import Request, serve_requests
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)]
    out = serve_requests(cfg, m, reqs, max_seq=prompts.shape[1] + new_tokens,
                         progress=progress, device=device)
    return [out.get(i) for i in range(len(reqs))]


def release() -> None:
    """Hand the memory of the program's dropped state back to the card (the
    caller drops its references first)."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
