"""device_fps: every frame whose step completed in the window, over the
window's wall time, which ends with a synchronize (device-fed cells)."""


def read(rec):
    if rec.feed != "device" or not rec.window_s:
        return None
    return rec.frames / rec.window_s
