"""device.idle_share: the share of the traced window in which no kernel,
copy or memset runs on the card (the union of their intervals)."""


def value(run):
    tr = run["trace"]
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
