"""K3's roofline share: the least time of its counted work
(``roofline/k3.py``) over its device time in the traced episodes."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "k3")
