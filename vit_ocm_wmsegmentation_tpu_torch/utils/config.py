"""Typed yacs-style config tree with the reference's key names.

The port's own copy of ``vit_ocm_wmsegmentation_tpu/utils/config.py`` (the
port imports nothing of the JAX package), key for key: a rebuild of
config.py (reference:13-210): a frozen attribute tree merged from
defaults, optional YAML files, ``--opts KEY VALUE`` pairs, and explicit
argparse mappings (update_config, reference:212-309). Key names are preserved
so the reference's flags and sweep YAMLs keep working; the quirks that were
bugs (``eval()`` on attribute names, falsy CLI values unable to override)
are deliberately fixed.
"""

from __future__ import annotations

import ast
import os

import yaml


class CfgNode(dict):
    """A dict with attribute access, freezing, and typed list-merge."""

    __frozen_key = "__frozen__"

    def __init__(self, d=None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        for k, v in (d or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"config is frozen; cannot set {name}")
        self[name] = value

    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def clone(self) -> "CfgNode":
        return CfgNode({k: (v.clone() if isinstance(v, CfgNode) else v) for k, v in self.items()})

    def merge_from_list(self, opts):
        """yacs-style ``--opts KEY VALUE [KEY VALUE ...]`` merge with literal
        parsing and dotted-key navigation."""
        assert len(opts) % 2 == 0, "--opts expects KEY VALUE pairs"
        for key, raw in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key: {key}")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node[leaf] = value

    def merge_from_dict(self, d: dict):
        for k, v in d.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str):
        with open(path) as f:
            self.merge_from_dict(yaml.safe_load(f) or {})

    def dump(self) -> str:
        def plain(n):
            return {k: (plain(v) if isinstance(v, CfgNode) else v) for k, v in n.items()}

        return yaml.safe_dump(plain(self), sort_keys=False)


def default_config() -> CfgNode:
    """Defaults mirroring reference config.py:13-210 (unused Swin/AUG subtree
    pruned; duplicated upper/lower-case keys collapsed to the upper-case
    spelling with lower-case aliases maintained at merge time)."""
    return CfgNode(
        {
            "BASE": [""],
            "DATA": {
                "BATCH_SIZE": 128,
                "DATA_PATH": "",
                "DATASET": "imagenet",
                "IMG_SIZE": 224,
                "INTERPOLATION": "bicubic",
                "PIN_MEMORY": True,
                "NUM_WORKERS": 8,
                "MASK_PATCH_SIZE": 32,
                "MASK_RATIO": 0.6,
                "IMAGE_PATH": "",
                "OUTPUT_DIR": "",
                # extension of the JAX package (not in the reference tree):
                # its device-side SimMIM transform (data/device_aug.py)
                "DEVICE_AUG": False,
            },
            "MODEL": {
                "TYPE": "vit",
                "NAME": "vit_small",
                "RESUME": "",
                "NUM_CLASSES": 1000,
                "DROP_RATE": 0.0,
                "DROP_PATH_RATE": 0.1,
                "LABEL_SMOOTHING": 0.1,
                "CHECKPOINT_KEY": "teacher",
                "PATCH_SIZE": 8,
                "VIT": {
                    "PATCH_SIZE": 16,
                    "IN_CHANS": 3,
                    "EMBED_DIM": 768,
                    "DEPTH": 12,
                    "NUM_HEADS": 12,
                    "MLP_RATIO": 4,
                    "QKV_BIAS": True,
                },
            },
            "TRAIN": {
                "START_EPOCH": 0,
                "EPOCHS": 300,
                "WARMUP_EPOCHS": 20,
                "WEIGHT_DECAY": 0.05,
                "BASE_LR": 5e-4,
                "WARMUP_LR": 5e-7,
                "MIN_LR": 5e-6,
                "CLIP_GRAD": 5.0,
                "AUTO_RESUME": True,
                "ACCUMULATION_STEPS": 0,
                "USE_CHECKPOINT": False,
                # the JAX package's training-path kernel routes (no
                # reference counterpart): "auto" is its shipped default;
                # "kernel+gp", LN_QKV "kernel" and ATTN_SAVE_P "on" take
                # the opt-in kernels (train/mim_trainer.train_routes)
                "MLP_REMAT": "auto",
                "LN_QKV": "auto",
                "ATTN_SAVE_P": "auto",
                # GPipe pipeline parallelism over PP_STAGES stages
                # (parallel/pp.py; microbatches 0 = one a stage) and FSDP
                # over the ranks' 'data' axis (parallel/mesh.py), both under
                # torchrun (train/mim_trainer.train_mim)
                "PP_STAGES": 1,
                "PP_MICROBATCHES": 0,
                "FSDP": False,
                "FSDP_MIN_SHARD": 4096,
                "LR_SCHEDULER": {
                    "NAME": "cosine",
                    "DECAY_EPOCHS": 30,
                    "DECAY_RATE": 0.1,
                    "GAMMA": 0.1,
                    "MULTISTEPS": [25, 30, 40],
                },
                "OPTIMIZER": {
                    "NAME": "adamw",
                    "EPS": 1e-8,
                    "BETAS": (0.9, 0.999),
                    "MOMENTUM": 0.9,
                },
                "LAYER_DECAY": 1.0,
            },
            "TEST": {"CROP": True},
            "AMP_OPT_LEVEL": "",
            "OUTPUT": "",
            "TAG": "default",
            "SAVE_FREQ": 5,
            "PRINT_FREQ": 10,
            "SEED": 0,
            "EVAL_MODE": False,
            "THROUGHPUT_MODE": False,
            "PRETRAINED": "",
            "WANDB": False,
            "LOSS_OPERATION": "max",
            "NUM_WORKERS": 1,
            "crop": 1,
            "batch_size": 1,
            "patch_size": 8,
            "method": "ours",
            "median_filter": 1,
            "PRETRAINED_WEIGHTS": "",
            "roi_masking": False,
            "H": 384,
            "W": 384,
            "ratio": 0.5,
            "checkpoint_key": "teacher",
            "finetune": True,
            "early_stopping": False,
            "eval_dataset_path": "",
            "image_size": 384,
        }
    )


# argparse attr -> list of config paths it sets (update_config, config.py:224-298)
_ARG_MAP = {
    "batch_size": ["DATA.BATCH_SIZE", "batch_size"],
    "pretrained_weights": ["PRETRAINED_WEIGHTS"],
    "output": ["OUTPUT"],
    "epochs": ["TRAIN.EPOCHS"],
    "warmup_epochs": ["TRAIN.WARMUP_EPOCHS"],
    "base_lr": ["TRAIN.BASE_LR"],
    "warmup_lr": ["TRAIN.WARMUP_LR"],
    "min_lr": ["TRAIN.MIN_LR"],
    "weight_decay": ["TRAIN.WEIGHT_DECAY"],
    "layer_decay": ["TRAIN.LAYER_DECAY"],
    "num_workers": ["NUM_WORKERS"],
    "mask_patch_size": ["DATA.MASK_PATCH_SIZE"],
    "mask_ratio": ["DATA.MASK_RATIO"],
    "arch": ["MODEL.NAME"],
    "patch_size": ["MODEL.PATCH_SIZE", "patch_size"],
    "checkpoint_key": ["MODEL.CHECKPOINT_KEY", "checkpoint_key"],
    "image_path": ["DATA.IMAGE_PATH"],
    "eval_dataset_path": ["eval_dataset_path"],
    "output_dir": ["DATA.OUTPUT_DIR"],
    "tag": ["TAG"],
    "wandb": ["WANDB"],
    "loss_operation": ["LOSS_OPERATION"],
    "crop": ["crop"],
    "method": ["method"],
    "median_filter": ["median_filter"],
    "roi_masking": ["roi_masking"],
    "H": ["H"],
    "W": ["W"],
    "ratio": ["ratio"],
    "finetune": ["finetune"],
    "early_stopping": ["early_stopping"],
}


def _set_path(cfg: CfgNode, path: str, value):
    node = cfg
    parts = path.split(".")
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def update_config(cfg: CfgNode, args) -> CfgNode:
    """Merge argparse args into the tree (reference update_config semantics,
    minus the can't-override-with-falsy bug: None means 'not passed').

    Order: flag mappings first, --opts LAST (the yacs convention — opts are
    the highest-priority override). The reference merges opts first and
    then lets every truthy argparse DEFAULT clobber them (config.py:218-221
    _check_args), so `--opts TRAIN.EPOCHS 100` silently reverted to the
    --epochs default there; falsy defaults (WANDB, roi_masking,
    early_stopping) additionally clobbered opts in this repo's r3 ordering.
    Documented delta: with both `--epochs N` and `--opts TRAIN.EPOCHS M`
    passed, M wins here (the reference keeps N)."""
    cfg.defrost()
    for attr, paths in _ARG_MAP.items():
        if hasattr(args, attr):
            val = getattr(args, attr)
            if val is not None and val != "":
                for p in paths:
                    _set_path(cfg, p, val)
    if hasattr(args, "image_size") and args.image_size is not None:
        size = args.image_size
        cfg.DATA.IMG_SIZE = size[0] if isinstance(size, (list, tuple)) else size
        cfg.image_size = size
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)
    # output dir templating (config.py:307)
    cfg.OUTPUT = os.path.join(cfg.OUTPUT, cfg.MODEL.NAME, f"{cfg.TAG}_{cfg.DATA.IMG_SIZE}_Experimental_Run")
    os.makedirs(cfg.OUTPUT, exist_ok=True)
    cfg.freeze()
    return cfg


def get_config(args) -> CfgNode:
    cfg = default_config()
    return update_config(cfg, args)
