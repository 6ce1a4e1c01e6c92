"""The plain reference: the dual-encoder MPNN, its loss, its gradients,
the clip and Adam, and the screening sweep, in plain float32 PyTorch from
the published description (the reference ``train_viscosity.py:139-231``
and ``train_melting_point.py:137-215``), with TF32 off.

It imports nothing of the program and takes nothing the program made:
it builds its own batches from the generator's records and takes the
weights the benchmark drew. :mod:`.precision` also gives the control, the
same arithmetic with every product's operands rounded to TF32.
"""
