"""The render kernel's share of its bytes bound in the traced
stretch, in % (``roofline.render_bytes`` at the cell's shapes)."""

from benchmark import roofline

read = roofline.reader("render_heatmaps_kernel")
