"""The paper's own benchmark shapes: the five standard ResNet-50 convolution
sizes [He et al. 2016] evaluated on GEMMINI in paper SS5 (batch 1000)."""
from repro_torch.core.conv_model import resnet50_layers, alexnet_layers  # noqa: F401

RESNET50 = resnet50_layers(1000)
ALEXNET = alexnet_layers(128)
