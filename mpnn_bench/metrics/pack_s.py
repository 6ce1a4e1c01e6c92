"""Set-up's packing of the training records into host batches: the
program's plan (``data/loader.py::plan_capacities``) and packer
(``iter_batches``, ``data/packing.py``) over every record. s."""


def read(ctx):
    return ctx["spans"].get("pack")
