"""The paper's group II pattern: ``powerlaw_graph``'s Chung-Lu graph
(``frozen``), skewed degrees and no locality.  Parameters: ``avg_deg``,
``alpha``."""
from bench import frozen


def pattern(n_nodes: int, params: dict, seed: int) -> tuple:
    return frozen.powerlaw_pattern(n_nodes, params["avg_deg"],
                                   params["alpha"], seed)
