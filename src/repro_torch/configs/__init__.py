"""Model and layer configurations. Only the paper's own ResNet-50 conv shapes
(``resnet50_convs``) are ported; the LM architecture configs come with the
transformer slice."""
