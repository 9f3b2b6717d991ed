"""ResNet18 + GroupNorm — the paper's CIFAR-100 / TinyImageNet model (FedDPC §5.2.1)."""
from repro_torch.models.vision import VisionConfig

CONFIG = VisionConfig(
    name="resnet18-gn", family="resnet18",
    image_size=32, channels=3, num_classes=100,
    width=64, groups=8,
)

SMOKE = VisionConfig(
    name="resnet18-gn-smoke", family="resnet18",
    image_size=16, channels=3, num_classes=10,
    width=16, groups=4,
)
