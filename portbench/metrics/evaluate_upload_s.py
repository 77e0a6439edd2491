"""evaluate_upload_s: Seconds of PTUnrooted.evaluate(engine="torch") and DevicePlacer's upload, by the
host clock ended by a device synchronise."""

LAYER = "Set-up: messages to the card"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    return run["setup"].get("evaluate_upload_s")
