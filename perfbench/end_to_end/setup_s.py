"""setup_s: Seconds from process start to the first timed call: imports, card initialisation, the program's libraries, its host tables and the warm-up calls."""
UNIT = "s"
SOURCE = "host_clock"


def read(record):
    return record["setup_s"]
