"""Multi-device execution (the twin of ``src/repro/distributed``): the
sharding rules, the explicit collectives and the expert-parallel MoE."""
