"""Training runtime (port of ``repro.runtime.train_loop``): the train
step factory and the fault-tolerant loop.

`make_train_step` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: microbatch gradients through
``torch.autograd.grad`` accumulated in f32, then the AdamW update, which
writes the parameters and moments in place (the reference donates its
buffers to the jitted step to the same end). `TrainLoop` wires in
checkpointing (async, auto-resume with the data state), preemption
handling, straggler monitoring, retry and the loss history.

A sharded step (the reference's ``mesh`` argument: FSDP + TP parameter
shardings and ZeRO moments) is the training half of
``distributed/sharding.py``, ROADMAP A5; the port refuses a mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.device import synchronize
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (
    PreemptionHandler,
    RetryPolicy,
    StepFailure,
    StragglerMonitor,
    retry_step,
)

MESH_REFUSAL = (
    "a sharded train step (FSDP/TP parameter shardings, ZeRO moments) is "
    "the training half of distributed/sharding.py, ROADMAP A5, not yet "
    "ported: train on one device (mesh=None, --model-axis 1)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    log_every: int = 10
    checkpoint_every: int = 200
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    num_microbatches: int = 1
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig
    )
    #: shared serving+training retry primitive: the train step retries
    #: transient failures under the same policy type ServeLoop uses for
    #: its dispatches (defaults match the old retry_step constants)
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)


def _on_device(batch: Dict[str, Any], device: torch.device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, opt_cfg: adamw.AdamWConfig, mesh=None,
                    num_microbatches: int = 1):
    """The ``(params, opt_state, batch) -> (params, opt_state, metrics)``
    step; ``batch`` leaves (numpy or tensors) go to the model's device.
    Metrics: the loss's (``loss``, ``ce``, ``aux``, ``tokens`` of the
    last microbatch, then ``loss`` the microbatches' mean), ``grad_norm``
    and ``lr``. The forward and backward write nothing, so a failure
    there can be retried; a failure inside the in-place update raises
    :class:`StepFailure`, which is not retried."""
    if mesh is not None:
        raise NotImplementedError(MESH_REFUSAL)

    def loss_fn(params, batch):
        return model.loss(params, batch)

    def step(params, opt_state, batch):
        loss, grads, metrics = adamw.accumulate_gradients(
            loss_fn, params, _on_device(batch, model.device),
            num_microbatches)
        try:
            params, opt_state, opt_metrics = adamw.update(
                grads, opt_state, params, opt_cfg)
        except Exception as exc:
            raise StepFailure(
                "the optimizer update failed part-way through its in-place "
                f"writes, so the step cannot be retried: {exc}") from exc
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


class TrainLoop:
    """Checkpointed, fault-tolerant training loop. ``seed`` draws the
    initial weights (:meth:`LMModel.init`)."""

    def __init__(self, model, train_cfg: TrainConfig, dataset, mesh=None,
                 seed: int = 0):
        if mesh is not None:
            raise NotImplementedError(MESH_REFUSAL)
        self.model = model
        self.cfg = train_cfg
        self.dataset = dataset
        self.seed = seed
        self.monitor = StragglerMonitor()
        self.preemption = PreemptionHandler()
        self.checkpointer = (
            AsyncCheckpointer(train_cfg.checkpoint_dir, train_cfg.keep_last)
            if train_cfg.checkpoint_dir else None
        )
        self.step_fn = make_train_step(
            model, train_cfg.optimizer, None, train_cfg.num_microbatches
        )
        self.history: list = []

    def _init_state(self) -> Tuple[Any, Any, int]:
        params = self.model.init(self.seed)
        opt_state = adamw.init(params, self.cfg.optimizer)
        start = 0
        if self.checkpointer:
            template = {
                "params": params, "opt": opt_state,
                "data": {"step": torch.zeros((), dtype=torch.int32)},
            }
            restored = restore_latest(self.checkpointer.base, template)
            if restored is not None:
                start, tree, _ = restored
                params, opt_state = tree["params"], tree["opt"]
                self.dataset.restore(
                    {"step": int(tree["data"]["step"])}
                )
        return params, opt_state, start

    def run(self) -> Dict[str, Any]:
        self.preemption.install()
        params, opt_state, start = self._init_state()
        step = start
        while step < self.cfg.total_steps and not self.preemption.should_stop:
            batch = next(self.dataset)
            t0 = time.perf_counter()
            params, opt_state, metrics = retry_step(
                self.step_fn, params, opt_state, batch,
                policy=self.cfg.retry,
            )
            synchronize(self.model.device)
            dt = time.perf_counter() - t0
            straggler = self.monitor.record(dt)
            step += 1
            if step % self.cfg.log_every == 0 or straggler:
                self.history.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "sec": dt, "straggler": straggler}
                )
            if self.checkpointer and step % self.cfg.checkpoint_every == 0:
                self._save(step, params, opt_state)
        if self.checkpointer:
            self._save(step, params, opt_state)
            self.checkpointer.wait()
        return {
            "final_step": step,
            "params": params,
            "opt_state": opt_state,
            "history": self.history,
            "median_step_time": self.monitor.median_step_time,
            "stragglers": self.monitor.flagged,
        }

    def _save(self, step, params, opt_state):
        self.checkpointer.save(
            step,
            {
                "params": params, "opt": opt_state,
                "data": {"step": torch.tensor(
                    self.dataset.state["step"], dtype=torch.int32)},
            },
            extra={"model": self.model.cfg.name},
        )
