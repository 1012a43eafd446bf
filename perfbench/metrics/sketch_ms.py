"""sketch_ms: the public sketch build (`build_mf_sketch`, or
`build_mf_log_sketch` in the log domain) on the cell's first problem and
``s``, timed by CUDA events after the window, median of five."""
import statistics


def read(rec):
    times = rec.get("sketch_event_ms")
    return statistics.median(times) if times else None
