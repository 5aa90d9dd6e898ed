"""Set-up: process start to the first timed operation (host clock)."""

UNIT = "s"


def read(obs):
    return obs.get("setup_s")
