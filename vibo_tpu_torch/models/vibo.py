"""VIBO: amortized variational inference for IRT (counterpart of
`vibo_tpu.models.vibo` on one device: the binary 1PL/2PL/3PL links, the
polytomous GRM/GPCM families and the deep nonlinear link, with every
posterior and conditioning family of the JAX config).

Generative model: theta_i ~ N(0, I_K), item d_j ~ N(0, I), r_ij ~
Bernoulli(sigmoid(a_j . theta_i - b_j)) on observed cells; under 3PL
Bernoulli(g_j + (1 - g_j) sigmoid(a_j . theta_i - b_j)), g_j =
sigmoid(g_hat_j), the guess logit a third item parameter; under grm/gpcm
r_ij is one of C ordered categories, with b_j the C-1 unconstrained
coordinates of the family's table (`links.categorical_table`); under deep
Bernoulli(sigmoid(MLP(theta_i, d_j))) with d_j an item latent vector and
the MLP's weights (`networks.apply_deep_link`) point-estimated.

Posterior: q(d) per-item diagonal Gaussians, or amortized from the
columns' statistics (item_encoder); q(theta_i | d, r_i) an MLP encoder on
the response row, conditioned on a flattened item draw ("sample"), the
item-posterior means ("mean") or the draw's sufficient statistics
("stats"), with a diagonal, Cholesky ("chol") or Fisher-anchored
("laplace", "laplace-w") covariance: every family hands on (mu, logvar,
off), off None for the diagonal one (`ops.distributions` tril_*).

Objectives: the packed full-batch ELBO and IWAE bound on the int8 code
(`elbo_packed_sums`, `iwae_packed_terms`, one per-sample body), and the
ELBO and IWAE bounds on decoded (response, mask) minibatches (`elbo`,
`iwae`), whose masked loglik runs the general kernel op under `use_pallas`
(`loglik_per_person`). Each objective has a core that takes its noise from
outside (`elbo_eps`, `iwae_eps`, `elbo_packed_sums`, `iwae_packed_terms`),
so the tests feed the JAX package and the port the same numbers;
`sample_noise` draws that noise from a torch.Generator, and `elbo` /
`iwae` / `iwae_packed` / `elbo_packed` wrap it around the cores. Samples
run batched along a leading axis on decoded data and one at a time on the
code; the item posterior is computed once an objective.

On a mesh (`vibo_tpu_torch.parallel`) the packed objectives take the
students group (`group=`: the item encoder's column statistics summed over
it), and a 2D (students, items) tile has its own forms
(`elbo_packed_sums_2d`, `iwae_packed_terms_2d`: the tile's item posterior,
the item-sharded encoder, the Fisher anchor's pair statistic summed over
the items group), as JAX's shard_map steps call them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.convert import tree_leaves
from vibo_tpu_torch.models import networks
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops import (likelihood, links, objectives, pallas_deep,
                                pallas_elbo, pallas_gpcm, pallas_grm)
from vibo_tpu_torch.ops.packing import decode_packed, packed_row_valid
from vibo_tpu_torch.parallel.mesh import group_size, psum

# the one-pass training loglik on theta (B, K) by link (1pl/2pl: the 2PL op)
_PACKED_TRAIN = {"3pl": pallas_elbo.masked_loglik_3pl_packed_train,
                 "grm": pallas_grm.masked_loglik_grm_packed_train,
                 "gpcm": pallas_gpcm.masked_loglik_gpcm_packed_train}


@dataclasses.dataclass(frozen=True)
class VIBOConfig:
    """The JAX config's fields (single device). theta_posterior: "diag"
    (independent per-dim Gaussians), "chol" (full covariance, the head
    widened by K(K-1)/2 Cholesky entries), "laplace" (the head's second
    block a per-dim log correction c of the closed-form Fisher structure
    (I + D S D)^-1, S_i = sum_j m_ij a_j a_j^T at the item means) or
    "laplace-w" (each item's term also weighted by the expected Fisher
    weight at the head's own mean). condition_on: the item draw
    ("sample"), the item means ("mean") or the draw's sufficient
    statistics ("stats", networks.condition_stat_mats). item_encoder:
    q(d_j | r_:,j) amortized from column statistics plus free residuals of
    the training items (new-item cold start)."""
    num_items: int
    irt_model: str = "2pl"
    num_categories: int = 2
    ability_dim: int = 1
    hidden_dim: int = 256
    conditional_posterior: bool = True
    condition_on: str = "sample"
    theta_posterior: str = "diag"
    item_encoder: bool = False
    item_encoder_hidden: int = 64      # the item encoder's MLP width
    use_pallas: bool = False
    compute_dtype: str = "float32"
    item_latent_dim: int = 16          # deep: item latent d_j's dimension
    deep_hidden_dim: int = 128         # deep: the link MLP's width H
    deep_fused_kernel: bool = False    # deep: the one-pass op under use_pallas
    deep_item_chunk: int = 256         # deep: items a checkpointed block of
                                       # the plain link (0 = all at once)

    def __post_init__(self):
        if self.irt_model not in links.IRT_MODELS:
            raise ValueError(
                f"irt_model must be one of {links.IRT_MODELS}")
        if self.condition_on not in ("sample", "mean", "stats"):
            raise ValueError(f"condition_on must be 'sample', 'mean' or "
                             f"'stats', got {self.condition_on!r}")
        if self.theta_posterior not in ("diag", "chol", "laplace",
                                        "laplace-w"):
            raise ValueError(f"unknown theta_posterior "
                             f"{self.theta_posterior!r}")
        if self.theta_posterior.startswith("laplace"):
            if self.irt_model == "deep":
                raise ValueError(
                    "theta_posterior='laplace' anchors on the linear-link "
                    "pair statistics sum_j m_ij a_j a_j^T; the deep link has "
                    "no per-item loading vector (its Gauss-Newton width is "
                    "evaluation.laplace_sigma_deep)")
            if self.item_encoder:
                raise ValueError(
                    "theta_posterior='laplace' + item_encoder is not "
                    "supported: the anchor uses the free-form item "
                    "posterior's means (use theta_posterior='chol' with the "
                    "item encoder)")
        if self.irt_model in links.CATEGORICAL_MODELS:
            if not 3 <= self.num_categories <= 32:
                raise ValueError(
                    f"{self.irt_model} needs num_categories in [3, 32] "
                    f"(2 categories IS the 2pl model), "
                    f"got {self.num_categories}")
        elif self.num_categories != 2:
            raise ValueError(
                f"num_categories={self.num_categories} only applies to the "
                f"polytomous families {links.CATEGORICAL_MODELS} (binary "
                f"links are 2-category)")


class VIBO:
    """VIBO model on one device; params are a tree of tensors
    (`convert` module docstring)."""

    def __init__(self, cfg: VIBOConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._categorical = cfg.irt_model in links.CATEGORICAL_MODELS
        self._deep = cfg.irt_model == "deep"
        self._head_spec = networks.item_head_spec(
            cfg.irt_model, cfg.ability_dim, cfg.item_latent_dim,
            cfg.num_categories)
        self._stats = (cfg.conditional_posterior
                       and cfg.condition_on == "stats")
        if not cfg.conditional_posterior:
            self._item_feat_dim = 0
        elif self._stats:
            self._item_feat_dim = sum(networks.condition_stat_dim(
                cfg.irt_model, cfg.ability_dim, cfg.item_latent_dim))
        else:
            self._item_feat_dim = networks.item_feat_dim(
                cfg.num_items, cfg.irt_model, cfg.ability_dim,
                cfg.item_latent_dim, cfg.num_categories)
        # the head carries Cholesky entries (chol at K > 1): its split
        # takes the ability dim; laplace heads are diag-shaped (mu, c), the
        # Cholesky token coming from the Fisher anchor
        self._chol = cfg.theta_posterior == "chol" and cfg.ability_dim > 1
        self._enc_k = cfg.ability_dim if self._chol else None
        self._laplace = cfg.theta_posterior.startswith("laplace")
        self._laplace_weighted = cfg.theta_posterior == "laplace-w"

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> dict:
        """Fresh trainable params from a seeded generator on the device.
        laplace (unweighted) starts the head's c block at log 0.15, near
        the Bernoulli Fisher weight's typical scale; laplace-w keeps c = 0,
        the closed-form Laplace covariance."""
        cfg = self.cfg
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        if cfg.item_encoder:
            items = {
                "item_enc": networks.init_item_encoder(
                    cfg.irt_model, cfg.ability_dim, g, self.device,
                    cfg.item_latent_dim, cfg.item_encoder_hidden,
                    cfg.num_categories),
                "item_resid": networks.init_item_residual(
                    cfg.num_items, cfg.irt_model, cfg.ability_dim, g,
                    self.device, cfg.item_latent_dim, cfg.num_categories)}
        else:
            items = {"item_post": networks.init_item_posterior(
                cfg.num_items, cfg.irt_model, cfg.ability_dim, g,
                self.device, cfg.item_latent_dim, cfg.num_categories)}
        params = {**items, "encoder": networks.init_ability_encoder(
            cfg.num_items, self._item_feat_dim, cfg.ability_dim,
            cfg.hidden_dim, g, self.device, chol=self._chol)}
        if self._laplace and not self._laplace_weighted:
            params["encoder"][-1]["b"][cfg.ability_dim:] += math.log(0.15)
        if self._deep:
            params["deep_link"] = networks.init_deep_link(
                cfg.ability_dim, cfg.item_latent_dim, cfg.deep_hidden_dim, g,
                self.device)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        return params

    # ------------------------------------------------------ item posterior

    def item_dist(self, params: dict, response=None, mask=None,
                  new_items: bool = False, group=None) -> dict:
        """The item posterior {name: {'mu', 'logvar': (M, D)}}: free-form,
        the per-item Gaussians in params; with item_encoder the shared
        encoder on the columns' statistics of (response, mask) (B, M) plus
        the training items' residuals, or without them for new_items
        (cold start; any column count). Deterministic given (params, data):
        each objective computes it once. group: on a mesh whose ranks hold
        student rows, the students group the column statistics are summed
        over (global, device-count-invariant statistics; JAX's
        axis_name)."""
        if not self.cfg.item_encoder:
            return params["item_post"]
        if response is None or mask is None:
            raise ValueError(
                "item_encoder=True amortizes q(d | r) from data: pass the "
                "(response, mask) the posterior should condition on")
        stats = networks.item_stats(response, mask, group=group)
        residual = None if new_items else params["item_resid"]
        return networks.apply_item_encoder(params["item_enc"], stats,
                                           self._head_spec, residual)

    def item_posterior_mean(self, params: dict, response=None,
                            mask=None) -> dict:
        return {name: p["mu"] for name, p in
                self.item_dist(params, response, mask).items()}

    def sample_items_from(self, post: dict,
                          generator: torch.Generator | None = None) -> dict:
        """One reparameterized draw {name: (M, D)} from an item_dist, the
        names in sorted order."""
        return {name: dist.reparameterize(post[name]["mu"],
                                          post[name]["logvar"], generator)
                for name in sorted(post)}

    def item_kl_from(self, post: dict) -> torch.Tensor:
        """Analytic sum_j KL(q(d_j) || N(0, I)) over all items and params."""
        return sum(dist.kl_standard_normal(p["mu"], p["logvar"]).sum()
                   for p in post.values())

    # the data-free forms (the free-form posterior; the amortized one needs
    # data: item_dist and the *_from methods)

    def sample_items(self, params: dict,
                     generator: torch.Generator | None = None) -> dict:
        return self.sample_items_from(self.item_dist(params), generator)

    def item_kl(self, params: dict) -> torch.Tensor:
        return self.item_kl_from(self.item_dist(params))

    def item_log_ratio(self, params: dict, sample: dict) -> torch.Tensor:
        return self.item_log_ratio_from(self.item_dist(params), sample)

    def item_log_ratio_from(self, post: dict, sample: dict) -> torch.Tensor:
        """log p(d) - log q(d) of an item draw (IWAE weights), summed over
        items and params; a draw with a leading sample axis gives (S,)."""
        total = 0.0
        items = (-2, -1)
        for name in sorted(post):
            p, z = post[name], sample[name]
            total = total + (
                dist.standard_normal_log_prob(z).sum(items)
                - dist.gaussian_log_prob(z, p["mu"], p["logvar"]).sum(items))
        return total

    # ---------------------------------------------- theta-posterior family

    def theta_kl(self, mu, logvar, off) -> torch.Tensor:
        """Per-person KL(q(theta_i) || N(0, I)), the last axis reduced."""
        return dist.kl_standard_normal_tril(mu, logvar, off)

    def theta_logq(self, theta, eps, mu, logvar, off) -> torch.Tensor:
        """Per-person log q(theta_i) at theta = mu + L eps (IWAE weights):
        the diagonal family's formula in theta, the full-covariance
        families' solve-free form in eps."""
        if off is None:
            return dist.gaussian_log_prob(theta, mu, logvar).sum(-1)
        return dist.tril_log_prob_from_eps(eps, logvar)

    def _encoder_conditioning(self, post: dict, item_sample: dict):
        """What q(theta | r, .) conditions on: the item draw ("sample",
        "stats"), the item-posterior means ("mean"), or None (mean-field)."""
        if not self.cfg.conditional_posterior:
            return None
        if self.cfg.condition_on == "mean":
            return {name: p["mu"] for name, p in post.items()}
        return item_sample

    def _cond_args(self, conditioning: dict | None):
        """_encoder_conditioning's output -> (item_feats, cond_mats): the
        flat item vector ("sample"/"mean") or the sufficient-statistic
        matrices ("stats")."""
        if conditioning is None:
            return None, None
        if self._stats:
            return None, networks.condition_stat_mats(
                conditioning, self.cfg.num_items, self.cfg.irt_model)
        return networks.flatten_item_sample(conditioning), None

    def _link_params(self, item_sample: dict, num_items: int):
        """Item sample -> (a (..., M, K), b (..., M), g_hat (..., M) or
        None): 1PL is 2PL with a unit a of (M, K), shared over any sample
        axis; g_hat is the 3PL guess logit, None for the other links;
        grm/gpcm keep their (..., M, C-1) b whole."""
        a = item_sample.get("a")
        if a is None:
            a = torch.ones((num_items, self.cfg.ability_dim),
                           device=item_sample["b"].device)
        g_hat = item_sample.get("g_hat")
        b = item_sample["b"]
        return (a, b if self._categorical else b[..., 0],
                None if g_hat is None else g_hat[..., 0])

    # ---------------------------------------------------- ability encoder

    def _anchor_theta_head(self, params: dict, head, mask,
                           items_group=None, item_post: dict | None = None):
        """laplace / laplace-w: the head's second block is the per-dim log
        correction c, and (mu, logvar, off) the Cholesky token of (I + D S
        D)^-1 (dist.laplace_anchor_parts), S_i = sum_j m_ij [w_ij] a_j
        a_j^T over the item-posterior means, w the expected Fisher weight
        at the head's own mean under laplace-w. mask (B, M) (any float
        dtype); the head may carry a leading sample axis. Other families:
        the head unchanged. items_group / item_post: on a 2D mesh tile,
        mask is the tile's (B, M_l) block and item_post its block of the
        posterior; the block's pair statistic is summed over the items
        group into the global per-person information."""
        if not self._laplace:
            return head
        mu, c, _ = head
        cfg = self.cfg
        k = cfg.ability_dim
        post = params["item_post"] if item_post is None else item_post
        mask = mask.float()
        if cfg.irt_model == "1pl":
            a = torch.ones((mask.shape[-1], k), device=mask.device)
        else:
            a = post["a"]["mu"]
        a2 = torch.stack([a[:, i] * a[:, j]
                          for i, j in dist.triu_flat_index(k)], -1)
        if self._laplace_weighted:
            mu32 = mu.float()
            b_mu = post["b"]["mu"]
            if self._categorical:
                w = likelihood.categorical_fisher_weight(
                    cfg.irt_model, links.grm_base(mu32, a),
                    links.categorical_table(cfg.irt_model, b_mu))
            elif cfg.irt_model == "3pl":
                w = likelihood.fisher_weight_3pl(
                    links.logits_2pl(mu32, a, b_mu[:, 0]),
                    post["g_hat"]["mu"][:, 0])
            else:   # 1pl: the Bernoulli weight with unit loadings
                w = likelihood.bernoulli_fisher_weight(
                    links.logits_2pl(mu32, a, b_mu[:, 0]))
            mask = mask * w
        logvar, off = dist.laplace_anchor_parts(
            c, psum(mask @ a2, items_group))
        return mu, logvar, off

    def encode(self, params: dict, response, mask, item_sample):
        """Dense encoder -> (mu, logvar, off), each (B, K) (off: (B,
        K(K-1)/2) for chol at K > 1 and the laplace families at K > 1, else
        None). item_sample is what the encoder conditions on (a draw or the
        means; None under mean-field); a draw with a leading sample axis
        gives the outputs that axis."""
        if response.shape[-1] != self.cfg.num_items:
            raise ValueError(
                f"response has {response.shape[-1]} items but the model was "
                f"configured with num_items={self.cfg.num_items}")
        feats, cond = self._cond_args(
            item_sample if self.cfg.conditional_posterior else None)
        head = networks.apply_ability_encoder(
            params["encoder"], response, mask, feats,
            compute_dtype=self.cfg.compute_dtype, ability_dim=self._enc_k,
            cond_mats=cond)
        return self._anchor_theta_head(params, head, mask)

    def _encode_packed(self, params: dict, packed, conditioning,
                       decoded=None, transposed: bool = False):
        """Encoder on the int8 code (fused first layer) -> (mu, logvar,
        off); transposed=True returns (muT, logvarT, None) as (K, B), the
        diagonal family only. decoded: the code's (mask, resp)
        (_decode_if_needed), which the stats correction and the Fisher
        anchor read."""
        if packed.shape[-1] != self.cfg.num_items:
            raise ValueError(
                f"packed has {packed.shape[-1]} items but the model was "
                f"configured with num_items={self.cfg.num_items}")
        if transposed and (self._chol or self._laplace):
            raise ValueError("the transposed (K, B) theta pipeline does not "
                             "carry the full-covariance families "
                             "(wants_transposed_theta)")
        feats, cond = self._cond_args(conditioning)
        head = networks.apply_ability_encoder_packed(
            params["encoder"], packed, feats,
            compute_dtype=self.cfg.compute_dtype,
            transposed_head=transposed, ability_dim=self._enc_k,
            cond_mats=cond, decoded=decoded)
        if not self._laplace:
            return head
        return self._anchor_theta_head(params, head, decoded[0])

    def wants_transposed_theta(self) -> bool:
        """True when the packed train path runs theta as (K, B): the fused
        kernels are on, the link is 1pl/2pl/3pl and the posterior is
        diagonal (the chol and laplace families run theta as (B, K), their
        Cholesky mixing a per-person recurrence, as in JAX); grm/gpcm and
        deep run theta as (B, K) too."""
        return (self.cfg.use_pallas and not self._chol and not self._laplace
                and self.cfg.irt_model in ("1pl", "2pl", "3pl"))

    def _use_packed_kernel(self, params: dict) -> bool:
        """Whether the packed path's loglik runs the link's one-pass op:
        under use_pallas, always for the linear and polytomous links; for
        deep only when deep_fused_kernel is set and the op supports the
        link's width (else the code is decoded and the plain link runs,
        JAX's default)."""
        if not self.cfg.use_pallas:
            return False
        if self._deep:
            return (self.cfg.deep_fused_kernel
                    and pallas_deep.supports(params["deep_link"]))
        return True

    def _decode_if_needed(self, params: dict, packed):
        """The code's (mask, resp) in f32 where a consumer on the packed
        path reads them (the plain deep link, the item encoder's column
        statistics, the stats correction, the Fisher anchor), else None
        (JAX's rule, with the stats correction's decode hoisted here from
        the encoder)."""
        if (self.cfg.item_encoder or self._laplace or self._stats
                or not self._use_packed_kernel(params)):
            return decode_packed(packed)
        return None

    # ------------------------------------------------------------ decoder

    def _deep_logits(self, params: dict, theta, item_sample: dict):
        """The deep link's logits (..., B, M), the plain link in checkpointed
        blocks of deep_item_chunk items."""
        return networks.apply_deep_link(
            params["deep_link"], theta, item_sample["d"],
            item_chunk=self.cfg.deep_item_chunk,
            compute_dtype=self.cfg.compute_dtype)

    def loglik_per_person(self, params: dict, theta, item_sample: dict,
                          response, mask) -> torch.Tensor:
        """Masked log p(r_i | theta_i, d) summed over items -> (..., B).
        theta and the item draw may carry a leading sample axis. grm/gpcm
        run the plain categorical likelihood (the JAX package has no
        polytomous masked kernel); for the binary links use_pallas runs the
        link's general kernel op (1PL as unit discriminations sized from the
        data), otherwise the links and the likelihood; deep runs the plain
        link in checkpointed item blocks (deep_item_chunk), as in JAX."""
        if self._deep:
            return likelihood.masked_loglik_per_person(
                self._deep_logits(params, theta, item_sample), response, mask)
        del params
        a, b, g_hat = self._link_params(item_sample, mask.shape[-1])
        if self._categorical:
            return likelihood.categorical_loglik_per_person(
                self.cfg.irt_model, links.grm_base(theta, a),
                links.categorical_table(self.cfg.irt_model, b), response,
                mask)
        if self.cfg.use_pallas:
            if g_hat is not None:
                return pallas_elbo.masked_loglik_3pl(theta, a, b, g_hat,
                                                     response, mask)
            return pallas_elbo.masked_loglik_2pl(theta, a, b, response, mask)
        if self.cfg.irt_model == "1pl":
            logits = links.logits_1pl(theta, b)
        else:
            logits = links.logits_2pl(theta, a, b)
        return likelihood.masked_loglik_per_person(logits, response, mask,
                                                   g_hat=g_hat)

    # --------------------------------------------------------- objective

    def _draw(self, params: dict, response, mask, item_eps: dict, theta_eps,
              post: dict | None = None):
        """What elbo and iwae share, all S samples at once: the item draws
        (S, M, D) from `post` (None = item_dist on (response, mask)), the
        encoder on (response, mask) conditioned on them, and theta (S, B,
        K) = mu + L eps. Returns (post, item_sample, (mu, logvar, off),
        theta)."""
        if post is None:
            post = self.item_dist(params, response, mask)
        item_sample = {
            name: dist.reparameterize_eps(item_eps[name], post[name]["mu"],
                                          post[name]["logvar"])
            for name in item_eps}
        q = self.encode(params, response, mask,
                        self._encoder_conditioning(post, item_sample))
        theta = dist.tril_reparameterize_eps(theta_eps, *q)
        return post, item_sample, q, theta

    def elbo_sums(self, params: dict, response, mask, item_eps: dict,
                  theta_eps, row_weight=None, post: dict | None = None):
        """(loglik_sum, kl_theta_sum, kl_items) on decoded data from
        exogenous noise (sample_noise), the first two averaged over the
        sample axis. Rows with no observed cell (the zero padding of a last
        minibatch) are inert: their loglik is 0 by the mask and row_weight
        ((B,), None = derived from the mask) drops their KL. post: the item
        posterior to draw from (None = item_dist on (response, mask))."""
        post, item_sample, q, theta = self._draw(
            params, response, mask, item_eps, theta_eps, post)
        ll = self.loglik_per_person(params, theta, item_sample, response,
                                    mask)
        valid = ((mask.sum(-1) > 0).to(q[0].dtype) if row_weight is None
                 else row_weight)
        kl = (self.theta_kl(*q) * valid).sum(-1)
        return ll.sum(-1).mean(), kl.mean(), self.item_kl_from(post)

    def elbo_eps(self, params: dict, response, mask, item_eps: dict,
                 theta_eps, item_scale: float = 1.0):
        """Minibatch ELBO (scalar) and its aux dict from exogenous noise; the
        item KL enters scaled by item_scale (batch / N)."""
        ll, klt, kli = self.elbo_sums(params, response, mask, item_eps,
                                      theta_eps)
        bound = objectives.elbo(ll, klt, kli, item_scale)
        return bound, {"elbo": bound, "loglik": ll, "kl_theta": klt,
                       "kl_items": kli}

    def elbo(self, params: dict, response, mask, item_scale: float = 1.0,
             num_samples: int = 1, generator: torch.Generator | None = None):
        """elbo_eps with num_samples draws of noise from `generator`."""
        item_eps, theta_eps = self.sample_noise(
            response.shape[-2], num_samples, generator=generator)
        return self.elbo_eps(params, response, mask, item_eps, theta_eps,
                             item_scale)

    def _theta_log_ratio(self, theta, eps, q, valid):
        """(log p(theta) summed over valid rows, log q(theta) likewise),
        each (..., ) over the leading sample axes."""
        lp = (dist.standard_normal_log_prob(theta).sum(-1) * valid).sum(-1)
        lq = (self.theta_logq(theta, eps, *q) * valid).sum(-1)
        return lp, lq

    def iwae_terms(self, params: dict, response, mask, item_eps: dict,
                   theta_eps, eval_mask=None, post: dict | None = None,
                   row_weight=None):
        """(local (S,), ratio (S,)) of the IWAE log-weights on decoded data:
        local_s = loglik + log p(theta_s) - log q(theta_s) over the valid
        rows, ratio_s = log p(d_s) - log q(d_s). The encoder conditions on
        (response, mask); the loglik and the valid rows (any evaluated cell,
        or row_weight where given) use eval_mask (None = mask). post: the
        item posterior to draw from (None = item_dist on (response,
        mask))."""
        emask = mask if eval_mask is None else eval_mask
        post, item_sample, q, theta = self._draw(
            params, response, mask, item_eps, theta_eps, post)
        ll = self.loglik_per_person(params, theta, item_sample, response,
                                    emask).sum(-1)
        valid = ((emask.sum(-1) > 0).to(q[0].dtype) if row_weight is None
                 else row_weight)
        lp, lq = self._theta_log_ratio(theta, theta_eps, q, valid)
        return ll + lp - lq, self.item_log_ratio_from(post, item_sample)

    def iwae_log_weights(self, params: dict, response, mask, item_eps: dict,
                         theta_eps, item_scale: float = 1.0,
                         eval_mask=None, post: dict | None = None
                         ) -> torch.Tensor:
        """(S,) importance log-weights log p(r, theta_s, d_s) - log
        q(theta_s, d_s), item terms scaled by item_scale (iwae_terms)."""
        local, ratio = self.iwae_terms(params, response, mask, item_eps,
                                       theta_eps, eval_mask, post)
        return local + item_scale * ratio

    def iwae_eps(self, params: dict, response, mask, item_eps: dict,
                 theta_eps, item_scale: float = 1.0) -> torch.Tensor:
        """IWAE-S bound (scalar) on the minibatch from exogenous noise."""
        return objectives.iwae_bound(self.iwae_log_weights(
            params, response, mask, item_eps, theta_eps, item_scale))

    def iwae(self, params: dict, response, mask, num_samples: int = 100,
             item_scale: float = 1.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """iwae_eps with num_samples draws of noise from `generator`."""
        item_eps, theta_eps = self.sample_noise(
            response.shape[-2], num_samples, generator=generator)
        return self.iwae_eps(params, response, mask, item_eps, theta_eps,
                             item_scale)

    def iwae_per_person(self, params: dict, response, mask,
                        num_samples: int = 100,
                        num_persons_total: int | None = None,
                        generator: torch.Generator | None = None,
                        noise: tuple | None = None) -> torch.Tensor:
        """Per-person IWAE-S bounds on log p(r_i) -> (B,). The shared item
        terms enter apportioned 1/N a person (N = num_persons_total, default
        B), the ELBO's item-KL convention; rows with no observed cell drop
        their theta terms. noise: (item_eps, theta_eps) as sample_noise
        gives them (the tests replay JAX's keys through it), else
        num_samples draws from `generator`."""
        n_total = num_persons_total or response.shape[-2]
        if noise is None:
            noise = self.sample_noise(response.shape[-2], num_samples,
                                      generator=generator)
        post, item_sample, q, theta = self._draw(
            params, response, mask, *noise)
        ll = self.loglik_per_person(params, theta, item_sample, response,
                                    mask)                         # (S, B)
        valid = (mask.sum(-1) > 0).to(q[0].dtype)
        lp = dist.standard_normal_log_prob(theta).sum(-1) * valid
        lq = self.theta_logq(theta, noise[1], *q) * valid
        ratio = self.item_log_ratio_from(post, item_sample) / n_total
        return objectives.iwae_bound(ll + lp - lq + ratio[:, None])

    def sample_noise(self, batch: int, num_samples: int,
                     transposed: bool = False,
                     generator: torch.Generator | None = None):
        """Exogenous noise for the objectives: ({name: (S, M, D)} item eps,
        theta eps (S, B, K), or (S, K, B) when transposed)."""
        cfg = self.cfg
        item_eps = {
            name: torch.randn((num_samples, cfg.num_items, d),
                              generator=generator, device=self.device)
            for name, d in sorted(self._head_spec.items())}
        shape = ((num_samples, cfg.ability_dim, batch) if transposed
                 else (num_samples, batch, cfg.ability_dim))
        return item_eps, torch.randn(shape, generator=generator,
                                     device=self.device)

    def _check_packed_layout(self, transposed: bool) -> None:
        if transposed and (self._categorical or self._deep):
            raise ValueError(f"{self.cfg.irt_model} runs theta as (B, K): "
                             "transposed=True is for the 1pl/2pl/3pl links")
        if transposed and not self.cfg.use_pallas:
            raise ValueError("transposed=True requires the fused kernels "
                             "(use_pallas=True)")

    def _packed_loglik(self, params: dict, theta, item_sample: dict, packed,
                       decoded, transposed: bool = False):
        """The masked loglik of a draw on the int8 code, summed over the
        persons: the link's one-pass op where _use_packed_kernel holds
        (theta (K, B) when transposed, else (B, K); the sum sees one scalar
        cotangent, the ops' uniform-cotangent contract), else
        loglik_per_person on the decoded code `decoded` ((mask, resp);
        deep without deep_fused_kernel, or a 2D tile without use_pallas)."""
        if not self._use_packed_kernel(params):
            return self.loglik_per_person(params, theta, item_sample,
                                          decoded[1], decoded[0]).sum()
        if self._deep:
            return pallas_deep.masked_loglik_deep_packed_train(
                theta, item_sample["d"], params["deep_link"], packed).sum()
        a, b, g_hat = self._link_params(item_sample, packed.shape[-1])
        if self._categorical:
            items = (a, links.categorical_table(self.cfg.irt_model, b))
        else:
            items = (a, b) if g_hat is None else (a, b, g_hat)
        if transposed:
            train_t = (pallas_elbo.masked_loglik_2pl_packed_train_t
                       if g_hat is None else
                       pallas_elbo.masked_loglik_3pl_packed_train_t)
            return train_t(theta, *items, packed)
        train = _PACKED_TRAIN.get(self.cfg.irt_model,
                                  pallas_elbo.masked_loglik_2pl_packed_train)
        return train(theta, *items, packed).sum()

    def _packed_samples(self, params: dict, packed, item_eps: dict,
                        theta_eps, transposed: bool, post: dict, decoded):
        """What the packed objectives share under use_pallas: yields per
        sample (ll_s, item_sample, (mu, logvar, off), theta) with ll_s the
        loglik summed over persons (_packed_loglik). The item posterior
        `post` and the decoded code are the objective's, computed once.

        The samples run as the JAX package's vmap over them runs: the item
        draws and the encoder once, on the draws' leading sample axis (the
        first layer's fused kernel once on the code, its backward once on
        the cotangent summed over the samples; each later layer one
        product on (S, B, H), its weight rounded to the compute dtype once
        and its gradient rounded once, after the sum over the samples); an
        encoder that reads no draw once for every sample. Then theta and
        the link's one-pass op, sample by sample."""
        items = {name: dist.reparameterize_eps(item_eps[name],
                                               post[name]["mu"],
                                               post[name]["logvar"])
                 for name in item_eps}
        q_all = self._encode_packed(
            params, packed, self._encoder_conditioning(post, items),
            decoded, transposed=transposed)
        for item_sample, q, theta in self._by_sample(items, q_all,
                                                     theta_eps):
            yield (self._packed_loglik(params, theta, item_sample, packed,
                                       decoded, transposed),
                   item_sample, q, theta)

    def _by_sample(self, items: dict, q_all: tuple, theta_eps):
        """(item draw, (mu, logvar, off), theta) sample by sample, from the
        draws and the encoder's output on their leading sample axis; an
        encoder that reads no draw ("mean", mean-field) gave one output,
        every sample's."""
        per_sample = (self.cfg.conditional_posterior
                      and self.cfg.condition_on != "mean")
        for s in range(theta_eps.shape[0]):
            q = (tuple(None if t is None else t[s] for t in q_all)
                 if per_sample else q_all)
            yield ({name: v[s] for name, v in items.items()}, q,
                   dist.tril_reparameterize_eps(theta_eps[s], *q))

    def _packed_post(self, params: dict, packed, group=None):
        """(item posterior, decoded code or None) of a packed objective:
        the item encoder's posterior conditions on the whole code (its
        statistics summed over the students group `group` on a mesh)."""
        decoded = self._decode_if_needed(params, packed)
        post = (self.item_dist(params, decoded[1], decoded[0], group=group)
                if self.cfg.item_encoder else self.item_dist(params))
        return post, decoded

    def elbo_packed_sums(self, params: dict, packed, item_eps: dict,
                         theta_eps, row_weight=None,
                         transposed: bool = False, group=None):
        """(loglik_sum, kl_theta_sum, kl_items) from the int8 code and
        exogenous noise, the first two averaged over the sample axis.

        With use_pallas the samples run _packed_samples (the fused first
        layer and the link's one-pass op). Without use_pallas the code is
        decoded and elbo_sums runs on (response, mask). row_weight ((B,),
        0/1) masks the theta-KL of rows with no observed cell and of a
        mesh's padding rows; None derives it from the code. transposed:
        theta in (K, B), theta_eps from sample_noise(..., transposed=True),
        fused kernels of the 1pl/2pl/3pl links and the diagonal family only
        (grm/gpcm run their one-pass op on theta (B, K), the table
        reparameterized outside it; deep its op or the plain link on theta
        (B, K)). Same math either way.

        group: on a students-only mesh, the students group: packed is this
        rank's rows, the two sums are its share, and the item encoder's
        column statistics are summed over the group, so kl_items is the
        same on every rank (the caller divides it by the group's size
        before the ranks' losses add up; JAX's axis_name)."""
        valid = (packed_row_valid(packed) if row_weight is None
                 else row_weight)
        self._check_packed_layout(transposed)
        if not self.cfg.use_pallas:
            mask, response = decode_packed(packed)
            return self.elbo_sums(
                params, response, mask, item_eps, theta_eps, valid,
                self.item_dist(params, response, mask, group=group))
        post, decoded = self._packed_post(params, packed, group)
        lls, klts = [], []
        for ll, _, q, _ in self._packed_samples(
                params, packed, item_eps, theta_eps, transposed, post,
                decoded):
            kl = (dist.kl_standard_normal(q[0], q[1]).sum(0) if transposed
                  else self.theta_kl(*q))
            klts.append((kl * valid).sum())
            lls.append(ll)
        return (torch.stack(lls).mean(), torch.stack(klts).mean(),
                self.item_kl_from(post))

    def iwae_packed_terms(self, params: dict, packed, item_eps: dict,
                          theta_eps, row_weight=None,
                          transposed: bool = False, group=None):
        """(local (S,), ratio (S,)) of the IWAE log-weights from the int8
        code and exogenous noise (the JAX `iwae_packed_terms`): local_s =
        loglik + log p(theta_s) - log q(theta_s) over the valid rows
        (row_weight, None = derived from the code), ratio_s = log p(d_s) -
        log q(d_s). Samples, layouts and the use_pallas=False fallback as
        in elbo_packed_sums (iwae_terms on the decoded code). group: on a
        students-only mesh local_s is this rank's rows' and ratio_s the
        same on every rank, so psum(local + item_scale * ratio / n) over
        the group is the global log-weight vector."""
        valid = (packed_row_valid(packed) if row_weight is None
                 else row_weight)
        self._check_packed_layout(transposed)
        if not self.cfg.use_pallas:
            mask, response = decode_packed(packed)
            return self.iwae_terms(
                params, response, mask, item_eps, theta_eps,
                post=self.item_dist(params, response, mask, group=group),
                row_weight=valid)
        post, decoded = self._packed_post(params, packed, group)
        local, ratio = [], []
        for s, (ll, item_sample, q, theta) in enumerate(self._packed_samples(
                params, packed, item_eps, theta_eps, transposed, post,
                decoded)):
            if transposed:
                lp = (dist.standard_normal_log_prob(theta).sum(0)
                      * valid).sum()
                lq = (dist.gaussian_log_prob(theta, q[0], q[1]).sum(0)
                      * valid).sum()
            else:
                lp, lq = self._theta_log_ratio(theta, theta_eps[s], q, valid)
            local.append(ll + lp - lq)
            ratio.append(self.item_log_ratio_from(post, item_sample))
        return torch.stack(local), torch.stack(ratio)

    def iwae_packed(self, params: dict, packed, item_scale: float = 1.0,
                    num_samples: int = 10, row_valid=None,
                    generator: torch.Generator | None = None):
        """IWAE-S bound (scalar) on the int8 code: iwae_packed_terms with
        num_samples draws of noise from `generator`, the item terms scaled
        by item_scale."""
        tp = self.wants_transposed_theta()
        item_eps, theta_eps = self.sample_noise(
            packed.shape[0], num_samples, transposed=tp, generator=generator)
        local, ratio = self.iwae_packed_terms(
            params, packed, item_eps, theta_eps, row_valid, transposed=tp)
        return objectives.iwae_bound(local + item_scale * ratio)

    def elbo_packed(self, params: dict, packed, item_scale: float = 1.0,
                    num_samples: int = 1, row_valid=None,
                    generator: torch.Generator | None = None,
                    noise: tuple | None = None):
        """ELBO (scalar) and its aux dict on the int8 code (the JAX
        `elbo_packed`, which draws its noise from a key): elbo_packed_sums
        on theta (B, K) with num_samples draws of noise from `generator`,
        or `noise` ((item_eps, theta_eps) as sample_noise gives them; the
        tests replay JAX's keys through it), the item KL scaled by
        item_scale."""
        if noise is None:
            noise = self.sample_noise(packed.shape[0], num_samples,
                                      generator=generator)
        ll, klt, kli = self.elbo_packed_sums(params, packed, *noise,
                                             row_valid)
        bound = objectives.elbo(ll, klt, kli, item_scale)
        return bound, {"elbo": bound, "loglik": ll, "kl_theta": klt,
                       "kl_items": kli}

    # ------------------------------------------------ 2D mesh tile (A9)

    def _encode_item_sharded(self, params: dict, response, mask, post: dict,
                             item_sample: dict, item_index: int,
                             items_group):
        """The encoder on a 2D mesh tile (networks.
        apply_ability_encoder_item_sharded), conditioned per condition_on:
        the tile's block of the draw or the means ("sample"/"mean"), or the
        tile's sufficient-statistic blocks at the GLOBAL item count
        ("stats"), whose psum over the items group gives the unsharded
        statistics."""
        conditioning = self._encoder_conditioning(post, item_sample)
        cond = None
        if conditioning is not None and self._stats:
            cond = networks.condition_stat_mats(
                conditioning, self.cfg.num_items, self.cfg.irt_model)
            conditioning = None
        return networks.apply_ability_encoder_item_sharded(
            params["encoder"], response, mask, conditioning,
            self.cfg.num_items, item_index, items_group,
            compute_dtype=self.cfg.compute_dtype, ability_dim=self._enc_k,
            cond_mats=cond)

    def _tile_item_post(self, params: dict, response, mask, item_index: int,
                        m_l: int, students_group, items_group) -> dict:
        """The item posterior of a 2D tile's item block: free-form, the
        per-item Gaussians sliced at item_index * m_l (their gradients are
        block-sparse); amortized, the shared encoder on the block's column
        statistics (partial sums over the students group, the per-person
        raw score over the items group: the global statistics) plus the
        sliced residuals."""
        off = item_index * m_l

        def block(tree):
            return {name: {k: v[k][off:off + m_l] for k in ("mu", "logvar")}
                    for name, v in tree.items()}
        if not self.cfg.item_encoder:
            return block(params["item_post"])
        stats = networks.item_stats(response, mask, group=students_group,
                                    item_group=items_group)
        return networks.apply_item_encoder(params["item_enc"], stats,
                                           self._head_spec,
                                           block(params["item_resid"]))

    def _tile_samples(self, params: dict, packed, item_eps: dict, theta_eps,
                      item_index: int, students_group, items_group):
        """What the 2D tile objectives share: the tile's (B_l, M_l) code
        decoded, its item posterior (computed once), the item draws on the
        block (item_eps sliced at item_index * M_l) and the item-sharded
        encoder's (mu, logvar, off) (the Fisher anchor's pair statistic
        summed over the items group), once on the draws' sample axis as
        _packed_samples runs them; then per sample theta (B_l, K) and the
        tile's loglik summed (_packed_loglik: the link's one-pass op on
        theta (B, K), or the plain deep link). Returns (post, generator of
        (ll, item_sample, q, theta))."""
        mask, response = decode_packed(packed)
        m_l = packed.shape[1]
        off = item_index * m_l
        post = self._tile_item_post(params, response, mask, item_index, m_l,
                                    students_group, items_group)

        def samples():
            items = {name: dist.reparameterize_eps(
                         item_eps[name][:, off:off + m_l], post[name]["mu"],
                         post[name]["logvar"])
                     for name in item_eps}
            q_all = self._anchor_theta_head(
                params, self._encode_item_sharded(
                    params, response, mask, post, items, item_index,
                    items_group),
                mask, items_group=items_group, item_post=post)
            for item_sample, q, theta in self._by_sample(items, q_all,
                                                         theta_eps):
                yield (self._packed_loglik(params, theta, item_sample,
                                           packed, (mask, response)),
                       item_sample, q, theta)
        return post, samples()

    def elbo_packed_sums_2d(self, params: dict, packed, item_eps: dict,
                            theta_eps, row_weight, item_index: int,
                            items_group=None, students_group=None):
        """A 2D ('students', 'items') mesh tile's ELBO partial sums from
        exogenous noise (the JAX `elbo_packed_sums_2d`): packed is the
        rank's (B_l, M_l) block, item_eps the whole (S, M, D) noise and
        theta_eps (S, B_l, K) its rows'. Returns (ll, klt, kli): the tile's
        masked loglik (the ranks' sum is the global one); its rows' theta
        KL, the same on every item shard of the row (theta comes from the
        psum'd encoder), so the caller divides it by the items axis; the
        item block's KL, the same on every student shard, divided by the
        students axis. row_weight is the rows' GLOBAL validity (a person
        may have no observed cell in this block and still be valid)."""
        post, samples = self._tile_samples(params, packed, item_eps,
                                           theta_eps, item_index,
                                           students_group, items_group)
        lls, klts = [], []
        for ll, _, q, _ in samples:
            lls.append(ll)
            klts.append((self.theta_kl(*q) * row_weight).sum())
        return (torch.stack(lls).mean(), torch.stack(klts).mean(),
                self.item_kl_from(post))

    def iwae_packed_terms_2d(self, params: dict, packed, item_eps: dict,
                             theta_eps, row_weight, item_index: int,
                             item_scale: float = 1.0, items_group=None,
                             students_group=None) -> torch.Tensor:
        """A 2D mesh tile's share of the IWAE log-weights (S,) (the JAX
        `iwae_packed_terms_2d`): the tile's loglik, its rows' log p(theta)
        - log q(theta) over the items axis (the same on every item shard)
        and the block's item log-ratio times item_scale over the students
        axis (the same on every student shard), so their psum over the
        whole mesh is the global log-weight vector."""
        n_i = group_size(items_group)
        n_s = group_size(students_group)
        post, samples = self._tile_samples(params, packed, item_eps,
                                           theta_eps, item_index,
                                           students_group, items_group)
        local = []
        for s, (ll, item_sample, q, theta) in enumerate(samples):
            lp, lq = self._theta_log_ratio(theta, theta_eps[s], q,
                                           row_weight)
            ratio = self.item_log_ratio_from(post, item_sample)
            local.append(ll + (lp - lq) / n_i + item_scale * ratio / n_s)
        return torch.stack(local)

    # ------------------------------------------------- scoring / imputation

    def response_prob(self, params: dict, theta, item_sample: dict):
        """p(r_ij = 1) matrix (B, M) of a binary link (deep: the sigmoid of
        the plain link's logits)."""
        if self._categorical:
            raise ValueError(f"{self.cfg.irt_model} responses are "
                             "polytomous: use category_logprobs / "
                             "impute_category_with_items")
        if self._deep:
            return torch.sigmoid(self._deep_logits(params, theta,
                                                   item_sample))
        lp = {"b": item_sample["b"][..., 0]}
        if "a" in item_sample:
            lp["a"] = item_sample["a"]
        if "g_hat" in item_sample:
            lp["g_hat"] = item_sample["g_hat"][..., 0]
        return links.response_prob(self.cfg.irt_model, theta, lp)

    def impute_prob(self, params: dict, response, mask):
        """Predicted response probabilities (B, M) from the posterior means:
        the item-posterior means (the item encoder's on this batch's
        columns) condition the encoder and, with its mean ability, go
        through the link (impute_prob_with_items)."""
        return self.impute_prob_with_items(
            params, response, mask,
            self.item_posterior_mean(params, response, mask))

    def impute_prob_with_items(self, params: dict, response, mask,
                               item_mean: dict):
        """Posterior-mean ability through the link at the item means (B, M)."""
        mu, _, _ = self.encode(params, response, mask, item_mean)
        return self.response_prob(params, mu, item_mean)

    def category_logprobs(self, params: dict, theta, item_sample: dict):
        """grm/gpcm all-category log-probabilities -> (..., B, M, C), the
        evaluation path (the training path never forms the category
        axis)."""
        del params
        if not self._categorical:
            raise ValueError("category_logprobs is the grm/gpcm evaluation "
                             "path")
        a, b, _ = self._link_params(item_sample, item_sample["b"].shape[-2])
        return likelihood.categorical_logprob_all(
            self.cfg.irt_model, links.grm_base(theta, a),
            links.categorical_table(self.cfg.irt_model, b))

    def impute_category_with_items(self, params: dict, response, mask,
                                   item_mean: dict):
        """grm/gpcm imputation: the most probable category per cell (B, M)
        under the posterior-mean ability and the item means."""
        mu, _, _ = self.encode(params, response, mask, item_mean)
        return self.category_logprobs(params, mu, item_mean).argmax(-1)
