"""Plain ``torch`` references: the mathematics each configuration
computes, written from cuDecomp's sources, in float64 where the program
runs float32.  They import nothing of the program and take nothing it
made but the data they are asked to check.  Each also carries its
*control*: the same mathematics with every stored value rounded to
bfloat16, the next precision below the configurations' float32, which
the check has to refuse."""
