"""Faults planted under the timed path: the harness tests plant them at a
size the CPU holds, ``portbench/readings.py`` at the cell's size on the
chip.  Each takes a ``pytest.MonkeyPatch`` and names the check that
catches it."""
import torch


def failing(out: dict) -> list[str]:
    """The checks of a result that exceed their limits."""
    return [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]


def stuck_step(monkeypatch):
    """A descent that returns its state unchanged (its KL read at that
    state, as the program reads it)."""
    from repro_torch.core import tsne
    step = tsne.tsne_step

    def stuck(state, graph, config, backend, lr, *args, **kwargs):
        _, stats = step(state, graph, config.early_exaggeration, config.momentum_initial,
                        backend=backend, lr=lr, min_gain=config.min_gain)
        return state, float(stats.kl), [], config.n_iter

    monkeypatch.setattr(tsne, "descend", stuck)


def moved_neighbours(monkeypatch):
    """Answers altered where they are produced: every neighbour index moved
    half the points on (never onto the row itself)."""
    from repro_torch import neighbors
    make = neighbors.make_neighbor_backend

    class Moved:
        def __init__(self, inner):
            self.inner, self.name = inner, inner.name

        def neighbors(self, x, k):
            idx, d2 = self.inner.neighbors(x, k)
            n = x.shape[0]
            rows = torch.arange(n, device=idx.device)[:, None]
            moved = (idx + n // 2) % n
            return torch.where(moved == rows, (moved + 1) % n, moved).to(idx.dtype), d2

    monkeypatch.setattr(neighbors, "make_neighbor_backend",
                        lambda name, options=None: Moved(make(name, options)))


def halved_repulsion(monkeypatch):
    """The Barnes-Hut step's repulsion halved where it is combined."""
    from repro_torch.core import tsne
    combine = tsne.combine_forces
    monkeypatch.setattr(tsne, "combine_forces",
                        lambda f_attr, kl_attr, f_rep, *a, **kw:
                        combine(f_attr, kl_attr, 0.5 * f_rep, *a, **kw))


FAULTS = {"stuck_step": (stuck_step, {"mnist_bh_fit": "z_ratio",
                                       "mouse_bh_descent": "z_ratio"}),
          "moved_neighbours": (moved_neighbours, {"mnist_bh_fit": "p_l1",
                                                  "mouse_bh_descent": "knn10_miss"}),
          "halved_repulsion": (halved_repulsion, "step_rel")}
