"""encode_roofline.train: the frozen bound of the window's encode work (perfbench/frozen/
bounds.py, counted from the cell's shapes and the reference pass) over the
device time of the kernels whose family (kernels/*.json) is of the encode
layer, in %."""


def read(r):
    return r.roofline_pct("encode")
