"""ka_roofline.serve (%): kernel K-A (ViT global attention forward) against its roofline: the sum of each
launch's bound from its shapes (harness/roofline.py) over the sum of the
device time of its kernels in the traced window."""

from harness import roofline


def setup(run):
    roofline.install_recorders(run)


def read(run):
    return roofline.roofline_percent(run, "K-A")
