"""Fixture: TAL000 — the file does not parse."""
def broken(:
    return
