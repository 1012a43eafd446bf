"""queue_wait_ms.<mix>: ``OTServer.stats()["mean_queue_wait_s"]`` over the
window: a request's wait from ``submit()`` to the start of its group's
dispatch."""


def read(rec):
    stats = rec.get("server_stats")
    if not stats or not stats["requests"] or "mean_queue_wait_s" not in stats:
        return None
    return stats["mean_queue_wait_s"] * 1e3
