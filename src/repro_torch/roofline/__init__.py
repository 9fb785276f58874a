"""Roofline terms of a step (the twin of ``src/repro/roofline/``):
`counting.costing` counts a step's operations, bytes, live memory and
collectives by dispatch, on meta tensors or on the card, and `analysis`
turns the counts into the three terms of the H100's roofline."""
