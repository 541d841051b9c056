"""Networks: ResNet-18/IN, cells, EyeNet, RefineNet and the EVE composite."""
