"""The plain reference that decides ``correct``: the clear-sky column
fluxes of a deployment's inputs, worked out again in plain PyTorch from
the raw inputs alone (``rtbench.reference.rt``).

It imports nothing of the program under test, of the JAX package or of
JAX.  Its constants and the principal-isotopologue partition sums
(``tips2017_iso1.json``) are frozen copies kept here, so a change to the
program cannot move the yardstick.
"""
