"""A frozen copy of the port's plain front end (pyramid, FAST, grid
selection, orientation, BRIEF), its undistortion and kernel B's plain form,
kept beside the benchmark so that later changes to the program cannot move
the reference. Kernel A and kernel B are their plain PyTorch forms here.
Nothing in this package imports the program."""
