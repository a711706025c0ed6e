"""The paper's group I pattern: ``banded_spd``'s pattern (``frozen``)
with unit weights.  Parameters: ``bandwidth``."""
from bench import frozen


def pattern(n_nodes: int, params: dict, seed: int) -> tuple:
    return frozen.banded_pattern(n_nodes, params["bandwidth"], seed)
