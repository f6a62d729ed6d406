"""Single-device strategy — the reference's plain scripts
(``imagenet-resnet50.py``, ``imagenet-pretrained-resnet50.py``: no
``tf.distribute`` anywhere, one GPU). The port of
:mod:`pddl_tpu.parallel.single`.

A mesh of this one process, with no process group: the step is
``strategy=None``'s, so moving from one card to many is a config change.
"""

from __future__ import annotations

from pddl_tpu_torch.core import dist
from pddl_tpu_torch.core.mesh import MeshConfig, build_mesh
from pddl_tpu_torch.parallel.base import Strategy, register_strategy


@register_strategy("single")
class SingleDeviceStrategy(Strategy):
    def __init__(self, device=None):
        super().__init__(MeshConfig(data=1), device=device)

    def setup(self):
        if self._mesh is None:
            self._mesh = build_mesh(MeshConfig(data=1),
                                    ranks=(dist.process_index(),),
                                    device=self._device)
        return self._mesh

    @property
    def data_process_count(self) -> int:
        return 1
