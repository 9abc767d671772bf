"""Multi-device encode: the scene batch over worker processes (gop.py)."""
