"""host.call_p95_ms (ms): the 95th percentile of the walls of every
map_batch / map_batch_pe call of the window outside its profiled stretch
(span `map`), the statistics.quantiles cut at 19/20.  Layer host loop."""
import statistics


def read(t):
    walls = t["call_walls"]
    if len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=20)[18]
