"""The kinds of request that traffic mixes name, a file each (see
traffic.py)."""
