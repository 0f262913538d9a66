"""The plain reference that decides ``correct``: greedy matching pursuit,
the dictionary-learning sweep and the octave filterbank, written from the
algorithm in plain PyTorch and NumPy. It imports nothing of the program."""
