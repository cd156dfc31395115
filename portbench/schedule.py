"""The t-SNE settings of a cell, as the program's ``TsneConfig`` takes them."""
from __future__ import annotations


def tsne_config(cell, n_iter: int, seed: int = 0):
    """``repro_torch.core.tsne.TsneConfig`` from the cell's configuration
    (objective and schedule) and traffic (method, neighbours, options)."""
    from repro_torch.core.tsne import TsneConfig
    c, t = cell.config, cell.traffic
    return TsneConfig(
        perplexity=c["perplexity"], n_iter=n_iter, theta=c["theta"],
        learning_rate=c["learning_rate"], early_exaggeration=c["early_exaggeration"],
        exaggeration_iters=c["exaggeration_iters"], momentum_initial=c["momentum_initial"],
        momentum_final=c["momentum_final"], momentum_switch_iter=c["momentum_switch_iter"],
        min_gain=c["min_gain"], seed=int(seed) % 2**31, method=t["method"],
        neighbor_method=t["neighbor_method"], **t.get("backend_options", {}))


def after_last_step(cell) -> tuple[float, float]:
    """(exaggeration, momentum) of the step that follows the configuration's
    ``n_iter`` steps."""
    c = cell.config
    it = c["n_iter"]
    return (c["early_exaggeration"] if it < c["exaggeration_iters"] else 1.0,
            c["momentum_initial"] if it < c["momentum_switch_iter"] else c["momentum_final"])
