"""``estimation.second_attempt_share``: % of the window's published mono frames
whose preferred estimator failed its gate, so that the other one ran too.  The
preferred one is the essential matrix iff the median parallax >= the config's
``distance``; ``used_essential`` names the one whose pose was kept, which is the
preferred one iff it passed.  From the port's own outputs; it repeats exactly
for a seed, and 0 is a reading."""


def read(run):
    published = [r["out"] for r in run.window if r["out"] is not None and r["out"]["published"]]
    if not published or "used_essential" not in published[0]:
        return None
    d = run.config["distance"]
    second = sum(1 for o in published
                 if bool(o["median_disparity"] >= d) != bool(o["used_essential"]))
    return 100.0 * second / len(published)
