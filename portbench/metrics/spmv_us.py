"""spmv_us: all the window's time, to the device's synchronisation at its
end, over the SpMV calls issued in it."""


def read(run):
    w = run.get("window")
    if run["kind"] != "product" or "slice" in run or not w or not w["ops"]:
        return None
    return 1e6 * w["seconds"] / w["ops"]
