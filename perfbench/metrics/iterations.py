"""iterations: the mean ``Solution.n_iter`` of the window's estimates."""


def read(rec):
    iters = rec.get("n_iter")
    return sum(iters) / len(iters) if iters else None
