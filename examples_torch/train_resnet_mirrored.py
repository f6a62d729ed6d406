"""Data-parallel ResNet training in ~20 lines (the mirrored-strategy story).

The port of ``examples/train_resnet_mirrored.py``. The reference needs an
86-line script for this (`imagenet-resnet50-mirror.py`); here the strategy
is one object and the batch arithmetic (32 x replicas, its line 54) is
`scale_batch_size`.

    python examples_torch/train_resnet_mirrored.py [--full] [--device cpu]

(real data: swap SyntheticImageClassification for
`pddl_tpu_torch.data.load_imagenet`). Runs on the card unless
``--device cpu``; without a card it raises.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pddl_tpu_torch.data.synthetic import SyntheticImageClassification  # noqa: E402
from pddl_tpu_torch.device import resolve_device  # noqa: E402
from pddl_tpu_torch.models.resnet import ResNet50, tiny_resnet  # noqa: E402
from pddl_tpu_torch.ops.augment import standard_augment  # noqa: E402
from pddl_tpu_torch.parallel import MirroredStrategy  # noqa: E402
from pddl_tpu_torch.train import Trainer  # noqa: E402
from pddl_tpu_torch.train.callbacks import (  # noqa: E402
    EarlyStopping,
    ReduceLROnPlateau,
)

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
p.add_argument("--full", action="store_true",
               help="ResNet-50 at 224 x 224 for 50 epochs, not the smoke run")
args = p.parse_args()
SMOKE = not args.full
device = resolve_device(args.device)

strategy = MirroredStrategy(device=device if device.type == "cpu" else None)
model = (tiny_resnet(num_classes=10, device=device) if SMOKE
         else ResNet50(num_classes=1000, device=device))
data = SyntheticImageClassification(
    batch_size=strategy.scale_batch_size(32),
    image_size=32 if SMOKE else 224,
    num_classes=10 if SMOKE else 1000,
)

trainer = Trainer(
    model, optimizer="adam", strategy=strategy,
    augment=standard_augment(crop=32 if SMOKE else 224),
)
history = trainer.fit(
    data, epochs=2 if SMOKE else 50, steps_per_epoch=4,
    validation_data=data, validation_steps=2,
    callbacks=[ReduceLROnPlateau(), EarlyStopping()], verbose=2,
)
print("final:", {k: round(v[-1], 4) for k, v in history.history.items()})
