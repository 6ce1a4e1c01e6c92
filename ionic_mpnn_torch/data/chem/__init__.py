"""Chemistry backends: pure-Python SMILES parsing (RDKit-compatible subset)."""
