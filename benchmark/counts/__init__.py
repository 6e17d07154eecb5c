"""Operations and bytes from shapes: the kernels' bounds and the model's FLOPs."""
