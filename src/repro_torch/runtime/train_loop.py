"""Training runtime (port of ``repro.runtime.train_loop``): the train
step factory and the fault-tolerant loop.

`make_train_step` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: microbatch gradients through
``torch.autograd.grad`` accumulated in f32, then the AdamW update, which
writes the parameters and moments in place (the reference donates its
buffers to the jitted step to the same end). `TrainLoop` wires in
checkpointing (async, auto-resume with the data state), preemption
handling, straggler monitoring, retry and the loss history.

With ``mesh`` (a ``(data, model)`` or ``(pod, data, model)``
:class:`~repro_torch.launch.mesh.Mesh`) the step is the reference's
sharded step: the parameters are laid out by ``param_shardings`` (ZeRO
over 'data', tensor parallelism over 'model', replicated over 'pod') as
:class:`~repro_torch.distributed.sharding.ShardedLeaf` s, the AdamW
moments mirror them, each data row (pod × data, pod major) takes its
rows of every microbatch, every row's gradients sum into the shards, and
the update runs shard by shard. Checkpoints hold the gathered logical arrays and the mesh's
fingerprint, so a run resumes on any mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
from repro_torch.device import synchronize
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.elastic import mesh_fingerprint
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (
    PreemptionHandler,
    RetryPolicy,
    StepFailure,
    StragglerMonitor,
    retry_step,
)

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


def shard_state(params, opt_state, mesh):
    """Logical params and AdamW state laid out over ``mesh``: the
    params by ``param_shardings``, each moment as its parameter (a
    factored moment's ``row`` / ``col`` by their own specs)."""
    specs = shd.param_shardings(params, mesh)

    def moments(tree):
        return None if tree is None else shd.shard_tree(
            tree, _moment_specs(tree, specs), mesh)

    return shd.shard_tree(params, specs, mesh), adamw.AdamWState(
        step=opt_state.step, mu=moments(opt_state.mu),
        nu=moments(opt_state.nu),
        compression_error=moments(opt_state.compression_error))


def _moment_specs(tree, specs):
    """The specs of a moment tree: its parameter's, and for a factored
    ``{"row", "col"}`` the parameter's without the reduced dim."""
    if isinstance(tree, dict) and not isinstance(specs, dict):
        return {"row": specs[:-1], "col": specs[:-2] + specs[-1:]}
    if isinstance(tree, dict):
        return {k: _moment_specs(v, specs[k]) for k, v in tree.items()}
    return specs


def gather_state(params, opt_state, device="cpu"):
    """:func:`shard_state`'s inverse: the logical params and AdamW state
    on ``device``."""
    def logical(tree):
        return None if tree is None else shd.gather_tree(tree, device)

    return logical(params), adamw.AdamWState(
        step=opt_state.step.to(device), mu=logical(opt_state.mu),
        nu=logical(opt_state.nu),
        compression_error=logical(opt_state.compression_error))


def make_train_step(model, opt_cfg: adamw.AdamWConfig, mesh=None,
                    num_microbatches: int = 1):
    """The ``(params, opt_state, batch) -> (params, opt_state, metrics)``
    step; ``batch`` leaves (numpy or tensors) go to the model's device,
    or with ``mesh`` to the mesh's first device, whence the model hands
    each data row its rows (params and state then sharded:
    :func:`shard_state`). With a share of a mesh (``Mesh.share``:
    params and state its shards, the batch logical) the step is that
    device's: its rows, its shards' update, the collectives priced
    stand-ins (the dry run's ``--mesh``).
    Metrics: the loss's (``loss``, ``ce``, ``aux``, ``tokens`` of the
    last microbatch, then ``loss`` the microbatches' mean), ``grad_norm``
    and ``lr``. The forward and backward write nothing, so a failure
    there can be retried; a failure inside the in-place update raises
    :class:`StepFailure`, which is not retried."""
    device = model.device if mesh is None else mesh.first_device

    def loss_fn(params, batch):
        return model.loss(params, batch, mesh=mesh)

    def step(params, opt_state, batch):
        loss, grads, metrics = adamw.accumulate_gradients(
            loss_fn, params, _on_device(batch, device), num_microbatches)
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
    initial weights (:meth:`LMModel.init`); with ``mesh`` they are laid
    out over it (:func:`shard_state`) and every step is the mesh's."""

    def __init__(self, model, train_cfg: TrainConfig, dataset, mesh=None,
                 seed: int = 0):
        self.model = model
        self.mesh = mesh
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
            model, train_cfg.optimizer, mesh, train_cfg.num_microbatches
        )
        self.history: list = []

    def _init_state(self) -> Tuple[Any, Any, int]:
        params = self.model.init(self.seed)
        if self.checkpointer:
            opt_state = adamw.init(params, self.cfg.optimizer)
            start, params, opt_state = self._restore(params, opt_state)
            if self.mesh is not None:
                params, opt_state = shard_state(params, opt_state, self.mesh)
            return params, opt_state, start
        if self.mesh is not None:      # the moments made beside the shards
            params = shd.shard_tree(
                params, shd.param_shardings(params, self.mesh), self.mesh)
        return params, adamw.init(params, self.cfg.optimizer), 0

    def _restore(self, params, opt_state):
        """The newest checkpoint's state in place of the fresh one (the
        logical arrays: a mesh lays them out after), and its step."""
        template = {
            "params": params, "opt": opt_state,
            "data": {"step": torch.zeros((), dtype=torch.int32)},
        }
        restored = restore_latest(self.checkpointer.base, template)
        if restored is None:
            return 0, params, opt_state
        start, tree, _ = restored
        self.dataset.restore({"step": int(tree["data"]["step"])})
        return start, tree["params"], tree["opt"]

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
            synchronize(self.model.device if self.mesh is None
                        else self.mesh.first_device)
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
        """The state's logical arrays (gathered to the host on a mesh),
        the data position, and the model's name and mesh fingerprint."""
        if self.mesh is not None:
            params, opt_state = gather_state(params, opt_state)
        self.checkpointer.save(
            step,
            {
                "params": params, "opt": opt_state,
                "data": {"step": torch.tensor(
                    self.dataset.state["step"], dtype=torch.int32)},
            },
            extra={"model": self.model.cfg.name,
                   "mesh": mesh_fingerprint(self.mesh)},
        )
