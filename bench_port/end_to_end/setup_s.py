"""Set-up: process start to the first timed step (imports, the program
built, the seed's weights, the cell's warm-up), on the host clock."""


def read(rec: dict, metric: dict):
  return rec["setup_s"]
