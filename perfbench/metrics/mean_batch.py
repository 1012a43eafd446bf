"""mean_batch.<mix>: ``OTServer.stats()["mean_batch"]`` over the window:
requests served a dispatched batch."""


def read(rec):
    stats = rec.get("server_stats")
    return stats["mean_batch"] if stats and stats["batches"] else None
