"""The soft-argmax kernel's share of its bytes bound in the traced
stretch, in % (``roofline.soft_argmax_bytes`` at the cell's shapes)."""

from benchmark import roofline

read = roofline.reader("soft_argmax_kernel")
