"""Analysis and diagnostics: PCA extraction figures, nonlinear-basis
reconstruction convergence, on-mesh accuracy between full and reduced
simulations, and the npy comparison tool (the exports of
``animsnapbases_tpu.analysis``).  matplotlib and polyscope are imported
only by the functions that draw or open a window."""

from animsnapbases_tpu_torch.analysis.figures import (
    plots_pca,
    plots_nonlinearity_basis,
)
from animsnapbases_tpu_torch.analysis.accuracy import (
    per_vertex_relative_l2,
    normal_angle_error,
    compute_accuracy,
)
from animsnapbases_tpu_torch.analysis.compare import compare_npy_files
