"""Offline tools of the PyTorch port, one module per script of the JAX
package's ``scripts/``, each run as ``python -m oryon_tpu_torch.scripts.<name>``
with that script's ``key=value`` arguments and printed lines:

  * ``train_pointdsc``      train the PointDSC solver on synthetic problems
  * ``sweep_checkpoints``   score every saved epoch of an experiment
  * ``sweep_eval_hparams``  score a grid of ``test.*`` variants of one checkpoint
  * ``compute_metrics``     rescore a prediction CSV
  * ``make_pair_split``     build a fixed pair split of a REAL275 / BOP tree
  * ``null_baselines``      score the identity and ground-truth predictors
  * ``sift_baseline``       score SIFT matches + RANSAC (needs OpenCV)
  * ``check_vsd_vs_gl``     hold the window rasteriser against OpenGL depth dumps
  * ``convert_pretrained``  the published torch checkpoints -> npz
  * ``make_dataset_assets``, ``make_synthetic_sn6d``  dataset files

The tools that compute on tensors take ``--device`` (default ``cuda``; it
raises without a card, ``--device cpu`` runs on the host).  The file tools
(``convert_pretrained``, ``make_dataset_assets``, ``make_synthetic_sn6d``)
are numpy on the host, as in the JAX package.
"""
