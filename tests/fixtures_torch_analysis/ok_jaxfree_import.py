"""Fixture negative: deliberately stdlib-only at module level; torch
loads inside the function that needs it."""
import json


def probe():
    import torch

    return json.dumps({"torch": torch.__name__})
