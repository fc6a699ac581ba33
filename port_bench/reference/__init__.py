"""The plain reference: what the served model and its search compute, in
plain PyTorch, with nothing of the program (see ``plain.py``)."""
