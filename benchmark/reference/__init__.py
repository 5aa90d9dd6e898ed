"""Plain references that decide ``correct``. They import nothing of the
program and take nothing it made: the benchmark hands them the inputs it
generated and the outputs the program produced, and they judge those."""
