"""The plain reference that decides ``correct``: PyTorch only, on any
device, and nothing of the program. It works out again from the graph
whatever it judges, and reads the program's outputs only to judge them.
"""
