"""Fixture negative: the file parses."""


def fine():
    return 1
