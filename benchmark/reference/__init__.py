"""The benchmark's plain reference. Float32 matrix products here run in
full float32: the TF32 control rounds its operands itself."""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
