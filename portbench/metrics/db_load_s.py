"""db_load_s: Seconds of the program's loaders of the DB's host pieces (MSA.load, CSFMIndex.load,
ProfileHMM.from_hmmer_file, PTUnrooted.load), by the host clock."""

LAYER = "Set-up: DB load"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    return run["setup"].get("db_load_s")
