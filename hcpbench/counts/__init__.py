"""Count functions: the operations and bytes a function needs at the
shapes seen at its entry, whatever the kernel that runs it does."""
