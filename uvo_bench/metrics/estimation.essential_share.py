"""``estimation.essential_share``: % of the window's published mono frames whose
relative pose ran the essential estimator (median parallax >= the config's
``distance``, or the essential matrix gave the pose), from the port's own
outputs; it repeats exactly for a seed."""


def read(run):
    published = [r["out"] for r in run.window if r["out"] is not None and r["out"]["published"]]
    if not published or "used_essential" not in published[0]:
        return None
    d = run.config["distance"]
    ran = sum(1 for o in published if o["median_disparity"] >= d or o["used_essential"])
    return 100.0 * ran / len(published)
