"""dispatch_us.devfed: host time of one call of the program's packed batch
step, the refresh excluded, by the host clock around each call; the mean
over the window's untraced batches."""


def read(rec):
    if rec.feed != "device" or not rec.dispatch_s:
        return None
    return sum(rec.dispatch_s) / len(rec.dispatch_s) * 1e6
