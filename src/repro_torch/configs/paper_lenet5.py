"""LeNet5 — the paper's CIFAR-10 model (FedDPC §5.2.1)."""
from repro_torch.models.vision import VisionConfig

CONFIG = VisionConfig(
    name="lenet5", family="lenet5",
    image_size=32, channels=3, num_classes=10,
)

SMOKE = VisionConfig(
    name="lenet5-smoke", family="lenet5",
    image_size=32, channels=3, num_classes=10,
)
