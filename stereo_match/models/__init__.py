from stereo_match.models.mccnn import (  # noqa: F401
    MCCNNFeatures, hinge_loss, init_params, make_model, make_train_step,
    mccnn_cost_volume, sample_training_patches, train,
)
