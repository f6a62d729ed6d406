"""Generic GPipe model wrapper: embed → staged body → head (the port of
:mod:`pddl_tpu.models.gpipe`).

:class:`GPipeModel` holds an ``embed`` and a ``head`` module, replicated
on every process, and ``n_stages`` stage modules of one structure in
``stages`` (the JAX model stacks their parameters on a leading
``[n_stages, ...]`` dim; here stage ``i``'s are ``stages.{i}.…``, leaf
``i`` of the stacked tree through :mod:`pddl_tpu_torch.bridge`). On a
mesh whose ``stage`` axis spans processes the model is built holding
only its process's stage (the others are empty placeholders, so the
names stay) beside the embed and the head: a model too deep for one card
is never laid out whole on any. On a mesh record with no processes (a
``stage`` axis of sizes only, :meth:`Mesh.shape_only`) it is built
whole. Either way each part,
the embed, stage ``i`` and the head, is drawn from its own generator
seeded from ``seed`` and the part (:meth:`GPipeModel.materialize`), so a
process's stage equals the whole model's. The model runs the schedule of
:func:`~pddl_tpu_torch.ops.pipeline.gpipe_apply` between the embed and
the head. :meth:`apply_sequential` applies every stage in turn with no
pipeline: the numerics oracle, on a model built whole. Stages run
deterministically (no dropout inside the pipeline).

The forward takes this process's rows (the strategy splits the batch
over ``data``) and returns the head's output on every stage.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
from torch import nn

from pddl_tpu_torch.core.mesh import STAGE_AXIS


class DroppedStage(nn.Module):
    """The place of a stage another process holds."""

    def forward(self, x):
        raise RuntimeError("this stage is held by another process")


class GPipeModel(nn.Module):
    """Pipeline-parallel model = embed + ``n_stages`` x stage + head."""

    def __init__(self, *, embed: nn.Module, stages: List[nn.Module],
                 head: nn.Module, n_stages: int, n_microbatches: int, mesh,
                 remat_stages: bool = False):
        super().__init__()
        if mesh.shape[STAGE_AXIS] != n_stages:
            raise ValueError(
                f"n_stages={n_stages} but the mesh's '{STAGE_AXIS}' axis has "
                f"size {mesh.shape[STAGE_AXIS]} — they must match (one "
                "pipeline stage per mesh position)"
            )
        if len(stages) != n_stages:
            raise ValueError(f"{len(stages)} stage modules for {n_stages} "
                             "stages")
        self.embed = embed
        self.stages = nn.ModuleList(stages)
        self.head = head
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.mesh = mesh
        self.remat_stages = remat_stages
        if mesh.axis_group(STAGE_AXIS) is not None:
            for i in range(n_stages):
                if i != self.stage_index:
                    self.stages[i] = DroppedStage()

    def materialize(self, device: torch.device,
                    draw: Callable[[nn.Module, torch.Generator], None],
                    seed: int) -> None:
        """Lay out the embed, the stages this process holds and the head
        (built on ``meta``) on ``device``, uninitialised, and ``draw``
        each part from its own generator seeded from ``(seed, part)``:
        the embed is part 0, stage ``i`` part ``i + 1``, the head part
        ``n_stages + 1``."""
        self.to_empty(device=device)
        if device.type == "meta":
            return
        parts = [self.embed, *self.stages, self.head]
        for k, part in enumerate(parts):
            if isinstance(part, DroppedStage):
                continue
            state = np.random.SeedSequence([seed, k]).generate_state(1)[0]
            draw(part, torch.Generator(device=device).manual_seed(int(state)))

    @property
    def stage_index(self) -> int:
        """This process's stage (its position on the ``stage`` axis)."""
        return self.mesh.axis_index(STAGE_AXIS) if self.n_stages > 1 else 0

    @property
    def is_whole(self) -> bool:
        """True when the model holds every stage (built on a mesh whose
        ``stage`` axis spans no processes)."""
        return not any(isinstance(s, DroppedStage) for s in self.stages)

    @property
    def device(self) -> torch.device:
        return next(self.head.parameters()).device

    @staticmethod
    def _stage_fn(stage: nn.Module, h: torch.Tensor) -> torch.Tensor:
        return stage(h)

    def forward(self, x, *, train: bool = True):
        from pddl_tpu_torch.ops.pipeline import gpipe_apply  # noqa: PLC0415

        h = self.embed(x)
        h = gpipe_apply(self.stages[self.stage_index], h, mesh=self.mesh,
                        stage_fn=self._stage_fn,
                        n_microbatches=self.n_microbatches,
                        remat_stages=self.remat_stages)
        return self.head(h)

    def apply_sequential(self, x):
        """Reference path: the same stages applied one after the other with
        no pipeline (a model built whole) — the numerics oracle."""
        if not self.is_whole:
            raise RuntimeError("apply_sequential needs every stage: build "
                               "the model on mesh.shape_only()")
        h = self.embed(x)
        for stage in self.stages:
            h = stage(h)
        return self.head(h)
