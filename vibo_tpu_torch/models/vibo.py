"""VIBO: amortized variational inference for IRT (counterpart of
`vibo_tpu.models.vibo`: the binary 1PL/2PL/3PL links, the polytomous
GRM/GPCM families and the deep nonlinear link, with free-form item
posteriors and the diagonal ability posterior).

Generative model: theta_i ~ N(0, I_K), item d_j ~ N(0, I), r_ij ~
Bernoulli(sigmoid(a_j . theta_i - b_j)) on observed cells; under 3PL
Bernoulli(g_j + (1 - g_j) sigmoid(a_j . theta_i - b_j)), g_j =
sigmoid(g_hat_j), the guess logit a third item parameter; under grm/gpcm
r_ij is one of C ordered categories, with b_j the C-1 unconstrained
coordinates of the family's table (`links.categorical_table`); under deep
Bernoulli(sigmoid(MLP(theta_i, d_j))) with d_j an item latent vector and
the MLP's weights (`networks.apply_deep_link`) point-estimated. Posterior:
q(d) per-item diagonal Gaussians; q(theta_i | d, r_i) an MLP encoder on the
response row, conditioned on a flattened item draw ("sample") or on the
item-posterior means ("mean").

Objectives: the packed full-batch ELBO and IWAE bound on the int8 code
(`elbo_packed_sums`, `iwae_packed_terms`, one per-sample body), and the
ELBO and IWAE bounds on decoded (response, mask) minibatches (`elbo`,
`iwae`), whose masked loglik runs the general kernel op under `use_pallas`
(`loglik_per_person`). Each objective has a core that takes its noise from
outside (`elbo_eps`, `iwae_eps`, `elbo_packed_sums`, `iwae_packed_terms`),
so the tests feed the JAX package and the port the same numbers;
`sample_noise` draws that noise from a torch.Generator, and `elbo` /
`iwae` / `iwae_packed` wrap it around the cores. Samples run
batched along a leading axis. Everything outside this scope raises NotImplementedError naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses

import torch

from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.convert import tree_leaves
from vibo_tpu_torch.models import networks
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops import (likelihood, links, objectives, pallas_deep,
                                pallas_elbo, pallas_gpcm, pallas_grm)
from vibo_tpu_torch.ops.packing import decode_packed, packed_row_valid

# the one-pass training loglik on theta (B, K) by link (1pl/2pl: the 2PL op)
_PACKED_TRAIN = {"3pl": pallas_elbo.masked_loglik_3pl_packed_train,
                 "grm": pallas_grm.masked_loglik_grm_packed_train,
                 "gpcm": pallas_gpcm.masked_loglik_gpcm_packed_train}


@dataclasses.dataclass(frozen=True)
class VIBOConfig:
    """The JAX config's fields that the port reads; values outside the
    port's scope raise. The item encoder's own fields come with the ROADMAP
    item that ports it."""
    num_items: int
    irt_model: str = "2pl"
    num_categories: int = 2
    ability_dim: int = 1
    hidden_dim: int = 256
    conditional_posterior: bool = True
    condition_on: str = "sample"
    theta_posterior: str = "diag"
    item_encoder: bool = False
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
        gaps = []
        if self.theta_posterior != "diag":
            gaps.append(f"theta_posterior={self.theta_posterior!r}")
        if self.conditional_posterior and self.condition_on == "stats":
            gaps.append("condition_on='stats'")
        if self.item_encoder:
            gaps.append("item_encoder=True")
        if gaps:
            raise NotImplementedError(
                "not ported yet (ROADMAP's 'Posterior and conditioning "
                "families'): " + "; ".join(gaps))


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
        self._item_feat_dim = (
            networks.item_feat_dim(cfg.num_items, cfg.irt_model,
                                   cfg.ability_dim, cfg.item_latent_dim,
                                   cfg.num_categories)
            if cfg.conditional_posterior else 0)

    # ------------------------------------------------------------- params

    def init_params(self, seed: int = 0) -> dict:
        """Fresh trainable params from a seeded generator on the device."""
        cfg = self.cfg
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        dims = [2 * cfg.num_items + self._item_feat_dim, cfg.hidden_dim,
                cfg.hidden_dim, 2 * cfg.ability_dim]
        params = {
            "item_post": networks.init_item_posterior(
                cfg.num_items, cfg.irt_model, cfg.ability_dim, g,
                self.device, cfg.item_latent_dim, cfg.num_categories),
            "encoder": networks.init_mlp(dims, g, self.device),
        }
        if self._deep:
            params["deep_link"] = networks.init_deep_link(
                cfg.ability_dim, cfg.item_latent_dim, cfg.deep_hidden_dim, g,
                self.device)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        return params

    # ------------------------------------------------------ item posterior

    def item_dist(self, params: dict) -> dict:
        """The free-form item posterior {name: {'mu', 'logvar': (M, D)}}."""
        return params["item_post"]

    def item_posterior_mean(self, params: dict) -> dict:
        return {name: p["mu"] for name, p in self.item_dist(params).items()}

    def item_kl_from(self, post: dict) -> torch.Tensor:
        """Analytic sum_j KL(q(d_j) || N(0, I)) over all items and params."""
        return sum(dist.kl_standard_normal(p["mu"], p["logvar"]).sum()
                   for p in post.values())

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

    def theta_logq(self, theta, mu, logvar) -> torch.Tensor:
        """Per-person log q(theta_i) (IWAE weights), the diagonal family."""
        return dist.gaussian_log_prob(theta, mu, logvar).sum(-1)

    def _encoder_conditioning(self, post: dict, item_sample: dict):
        """What q(theta | r, .) conditions on: the item draw ("sample"), the
        item-posterior means ("mean"), or None (mean-field)."""
        if not self.cfg.conditional_posterior:
            return None
        if self.cfg.condition_on == "mean":
            return {name: p["mu"] for name, p in post.items()}
        return item_sample

    def _item_feats(self, post: dict, item_sample: dict):
        """_encoder_conditioning, flattened (None under mean-field)."""
        cond = self._encoder_conditioning(post, item_sample)
        return None if cond is None else networks.flatten_item_sample(cond)

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

    def encode(self, params: dict, response, mask, item_sample):
        """Dense encoder -> (mu, logvar, None), each (B, K). item_sample is
        what the encoder conditions on (a draw or the means); None under
        mean-field."""
        if response.shape[-1] != self.cfg.num_items:
            raise ValueError(
                f"response has {response.shape[-1]} items but the model was "
                f"configured with num_items={self.cfg.num_items}")
        feats = (networks.flatten_item_sample(item_sample)
                 if self.cfg.conditional_posterior else None)
        return networks.apply_ability_encoder(
            params["encoder"], response, mask, feats,
            compute_dtype=self.cfg.compute_dtype)

    def _encode_packed(self, params: dict, packed, item_feats,
                       transposed: bool = False):
        """Encoder on the int8 code (fused first layer); transposed=True
        returns (muT, logvarT, None) as (K, B)."""
        if packed.shape[-1] != self.cfg.num_items:
            raise ValueError(
                f"packed has {packed.shape[-1]} items but the model was "
                f"configured with num_items={self.cfg.num_items}")
        return networks.apply_ability_encoder_packed(
            params["encoder"], packed, item_feats,
            compute_dtype=self.cfg.compute_dtype,
            transposed_head=transposed)

    def wants_transposed_theta(self) -> bool:
        """True when the packed train path runs theta as (K, B): the fused
        kernels are on and the link is 1pl/2pl/3pl (the posterior is
        diagonal always, in the port's scope); grm/gpcm and deep run theta
        as (B, K), as in JAX."""
        return (self.cfg.use_pallas
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
        (S, M, D) from `post` (None = item_dist), the encoder on (response,
        mask) conditioned on them, and theta (S, B, K). Returns (post,
        item_sample, mu, logvar, theta)."""
        if post is None:
            post = self.item_dist(params)
        item_sample = {
            name: dist.reparameterize_eps(item_eps[name], post[name]["mu"],
                                          post[name]["logvar"])
            for name in item_eps}
        mu, logvar, _ = self.encode(
            params, response, mask,
            self._encoder_conditioning(post, item_sample))
        theta = dist.reparameterize_eps(theta_eps, mu, logvar)
        return post, item_sample, mu, logvar, theta

    def elbo_sums(self, params: dict, response, mask, item_eps: dict,
                  theta_eps, row_weight=None):
        """(loglik_sum, kl_theta_sum, kl_items) on decoded data from
        exogenous noise (sample_noise), the first two averaged over the
        sample axis. Rows with no observed cell (the zero padding of a last
        minibatch) are inert: their loglik is 0 by the mask and row_weight
        ((B,), None = derived from the mask) drops their KL."""
        post, item_sample, mu, logvar, theta = self._draw(
            params, response, mask, item_eps, theta_eps)
        ll = self.loglik_per_person(params, theta, item_sample, response,
                                    mask)
        valid = ((mask.sum(-1) > 0).to(mu.dtype) if row_weight is None
                 else row_weight)
        kl = (dist.kl_standard_normal(mu, logvar).sum(-1) * valid).sum(-1)
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

    def iwae_terms(self, params: dict, response, mask, item_eps: dict,
                   theta_eps, eval_mask=None, post: dict | None = None,
                   row_weight=None):
        """(local (S,), ratio (S,)) of the IWAE log-weights on decoded data:
        local_s = loglik + log p(theta_s) - log q(theta_s) over the valid
        rows, ratio_s = log p(d_s) - log q(d_s). The encoder conditions on
        (response, mask); the loglik and the valid rows (any evaluated cell,
        or row_weight where given) use eval_mask (None = mask). post: the
        item posterior to draw from (None = item_dist)."""
        emask = mask if eval_mask is None else eval_mask
        post, item_sample, mu, logvar, theta = self._draw(
            params, response, mask, item_eps, theta_eps, post)
        ll = self.loglik_per_person(params, theta, item_sample, response,
                                    emask).sum(-1)
        valid = ((emask.sum(-1) > 0).to(mu.dtype) if row_weight is None
                 else row_weight)
        lp = (dist.standard_normal_log_prob(theta).sum(-1) * valid).sum(-1)
        lq = (self.theta_logq(theta, mu, logvar) * valid).sum(-1)
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
        post, item_sample, mu, logvar, theta = self._draw(
            params, response, mask, *noise)
        ll = self.loglik_per_person(params, theta, item_sample, response,
                                    mask)                         # (S, B)
        valid = (mask.sum(-1) > 0).to(mu.dtype)
        lp = dist.standard_normal_log_prob(theta).sum(-1) * valid
        lq = self.theta_logq(theta, mu, logvar) * valid
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

    def _packed_samples(self, params: dict, packed, item_eps: dict,
                        theta_eps, transposed: bool):
        """What the packed objectives share under use_pallas, one sample at
        a time: yields (ll_s, item_sample, mu, logvar, theta) with ll_s the
        loglik summed over persons. The encoder's first layer runs the fused
        kernel, the loglik the link's one-pass op where _use_packed_kernel
        holds (each sample's sum sees one scalar cotangent: the ELBO's 1/S,
        the IWAE's weight w_s, so the ops' uniform-cotangent contract
        holds); otherwise (deep without deep_fused_kernel) the code is
        decoded for the plain link."""
        post = self.item_dist(params)
        m = packed.shape[-1]
        fused = self._use_packed_kernel(params)
        if not fused:                      # deep on the plain link
            mask, response = decode_packed(packed)
        for s in range(theta_eps.shape[0]):
            item_sample = {
                name: dist.reparameterize_eps(item_eps[name][s],
                                              post[name]["mu"],
                                              post[name]["logvar"])
                for name in item_eps}
            mu, logvar, _ = self._encode_packed(
                params, packed, self._item_feats(post, item_sample),
                transposed=transposed)
            theta = dist.reparameterize_eps(theta_eps[s], mu, logvar)
            if self._deep:
                ll = (pallas_deep.masked_loglik_deep_packed_train(
                    theta, item_sample["d"], params["deep_link"], packed)
                    if fused else self.loglik_per_person(
                        params, theta, item_sample, response, mask)).sum()
                yield ll, item_sample, mu, logvar, theta
                continue
            a, b, g_hat = self._link_params(item_sample, m)
            if self._categorical:
                items = (a, links.categorical_table(self.cfg.irt_model, b))
            else:
                items = (a, b) if g_hat is None else (a, b, g_hat)
            if transposed:
                train_t = (pallas_elbo.masked_loglik_2pl_packed_train_t
                           if g_hat is None else
                           pallas_elbo.masked_loglik_3pl_packed_train_t)
                ll = train_t(theta, *items, packed)
            else:
                train = _PACKED_TRAIN.get(
                    self.cfg.irt_model,
                    pallas_elbo.masked_loglik_2pl_packed_train)
                ll = train(theta, *items, packed).sum()
            yield ll, item_sample, mu, logvar, theta

    def elbo_packed_sums(self, params: dict, packed, item_eps: dict,
                         theta_eps, row_weight=None,
                         transposed: bool = False):
        """(loglik_sum, kl_theta_sum, kl_items) from the int8 code and
        exogenous noise, the first two averaged over the sample axis.

        With use_pallas the samples run _packed_samples (the fused first
        layer and the link's one-pass op). Without use_pallas the code is
        decoded and elbo_sums runs on (response, mask). row_weight ((B,),
        0/1) masks the theta-KL of rows with no observed cell; None derives
        it from the code. transposed: theta in (K, B), theta_eps from
        sample_noise(..., transposed=True), fused kernels of the 1pl/2pl/3pl
        links only (grm/gpcm run their one-pass op on theta (B, K), the
        table reparameterized outside it; deep its op or the plain link on
        theta (B, K)). Same math either way."""
        valid = (packed_row_valid(packed) if row_weight is None
                 else row_weight)
        self._check_packed_layout(transposed)
        if not self.cfg.use_pallas:
            mask, response = decode_packed(packed)
            return self.elbo_sums(params, response, mask, item_eps,
                                  theta_eps, valid)
        lls, klts = [], []
        for ll, _, mu, logvar, _ in self._packed_samples(
                params, packed, item_eps, theta_eps, transposed):
            kl = dist.kl_standard_normal(mu, logvar).sum(0 if transposed
                                                         else -1)
            klts.append((kl * valid).sum())
            lls.append(ll)
        return (torch.stack(lls).mean(), torch.stack(klts).mean(),
                self.item_kl_from(self.item_dist(params)))

    def iwae_packed_terms(self, params: dict, packed, item_eps: dict,
                          theta_eps, row_weight=None,
                          transposed: bool = False):
        """(local (S,), ratio (S,)) of the IWAE log-weights from the int8
        code and exogenous noise (the JAX `iwae_packed_terms` on one
        device): local_s = loglik + log p(theta_s) - log q(theta_s) over the
        valid rows (row_weight, None = derived from the code), ratio_s =
        log p(d_s) - log q(d_s). Samples, layouts and the use_pallas=False
        fallback as in elbo_packed_sums (iwae_terms on the decoded code)."""
        valid = (packed_row_valid(packed) if row_weight is None
                 else row_weight)
        self._check_packed_layout(transposed)
        if not self.cfg.use_pallas:
            mask, response = decode_packed(packed)
            return self.iwae_terms(params, response, mask, item_eps,
                                   theta_eps, row_weight=valid)
        post = self.item_dist(params)
        kdim = 0 if transposed else -1
        local, ratio = [], []
        for ll, item_sample, mu, logvar, theta in self._packed_samples(
                params, packed, item_eps, theta_eps, transposed):
            lp = (dist.standard_normal_log_prob(theta).sum(kdim)
                  * valid).sum()
            lq = (dist.gaussian_log_prob(theta, mu, logvar).sum(kdim)
                  * valid).sum()
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
        the item-posterior means condition the encoder and, with its mean
        ability, go through the link (impute_prob_with_items)."""
        return self.impute_prob_with_items(params, response, mask,
                                           self.item_posterior_mean(params))

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
