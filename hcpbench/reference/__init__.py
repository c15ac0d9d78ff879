"""Plain fp32 PyTorch reference of the benchmarked models; imports nothing of the program."""
